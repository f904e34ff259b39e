"""Plain-torch limb helpers shared by the field ops and the kernels' plain
versions.

The port stores a field element as 8 little-endian 32-bit limbs in an int32
tensor (uint32 bit patterns). torch has no unsigned 32-bit arithmetic on most
CPU ops, so the plain versions widen to int64 — 32-bit limbs for additions,
16-bit half-limbs for products — and mask explicitly. No counterpart in the
JAX package, whose 8-bit digit helpers live in
`paillier_halo2_tpu/ff/field_jax.py:90-155`.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF


def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> their uint32 values as int64."""
    return x.to(torch.int64) & M32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors holding the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
