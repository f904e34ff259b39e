"""K7 and the redundant form: field elements held as any integer in [0, 2p).

Counterpart of `paillier_halo2_tpu/ff/lazy_mont.py:1`. The JAX package keeps
"lazy" values as signed base-256 digits with trace-time bounds because the
TPU's vector unit has no carry chain. Hopper has one, so the port keeps its
`(8, N)` int32 limbs and gives up only the normalisation: a product skips
its final conditional subtraction, sums and differences stay in [0, 2p), and
one `canonicalize` runs where a pipeline ends. The invariant and its proof
(4p < R = 2^256 for Fr and Fq) are in `csrc/field.cuh`.

- `mont_mul_lazy` (K7) <- `mont_mul_lazy_pallas` (:301): a*b*R^-1 + k*p with
  k in {0, 1}, for a, b in [0, 2p). On a CUDA tensor it launches
  `csrc/mont_mul_lazy.cu` or raises; on a CPU tensor it runs
  `mont_mul_lazy_plain`, the same bits. Bound: memory, 96 B per lane.
- `add_lazy`, `sub_lazy`: the kernels' range-keeping sum and difference, in
  plain torch (the point kernels' plain versions use them).
- `canonicalize` <- `canonicalize` (:202): [0, 2p) -> [0, p), plain torch;
  a value that is zero mod p becomes exact zero.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from .limbs16 import M32, to_i32, u64
from .mulmod import _FIELD_IDS, _check, redc_plain

LAUNCHES = {"mont_mul_lazy": 0}


def _p2_limbs(spec) -> tuple[int, ...]:
    return tuple(((2 * spec.p) >> (32 * k)) & M32 for k in range(8))


def mont_mul_lazy_plain(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7's function in plain torch: the CIOS value (a*b + m*p) / R with no
    conditional subtraction, below 2p for a, b below 2p."""
    u, _ = redc_plain(spec, a, b)  # bit 256 is 0: u < 2p < R
    return to_i32(torch.stack(u))


def add_lazy(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, minus 2p if that is >= 2p (field.cuh `add_lazy_cc`)."""
    ua, ub = u64(a), u64(b)
    p2 = _p2_limbs(spec)
    s, c = [], 0
    for k in range(8):  # a + b < 4p < R: no carry out
        v = ua[k] + ub[k] + c
        s.append(v & M32)
        c = v >> 32
    d, bw = [], 0
    for k in range(8):
        x = s[k] - p2[k] - bw
        d.append(x & M32)
        bw = (x >> 32) & 1
    return to_i32(torch.where(bw != 0, torch.stack(s), torch.stack(d)))


def sub_lazy(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, plus 2p if that borrows (field.cuh `sub_lazy_cc`)."""
    ua, ub = u64(a), u64(b)
    p2 = _p2_limbs(spec)
    d, bw = [], 0
    for k in range(8):
        x = ua[k] - ub[k] - bw
        d.append(x & M32)
        bw = (x >> 32) & 1
    out, c = [], 0
    for k in range(8):
        v = d[k] + p2[k] * bw + c
        out.append(v & M32)
        c = v >> 32
    return to_i32(torch.stack(out))


def canonicalize(spec, x: torch.Tensor) -> torch.Tensor:
    """(8, *batch) values in [0, 2p) -> the same values mod p, in [0, p)."""
    ux = u64(x)
    d, bw = [], 0
    for k in range(8):
        v = ux[k] - spec.p_limbs[k] - bw
        d.append(v & M32)
        bw = (v >> 32) & 1
    return to_i32(torch.where(bw != 0, ux, torch.stack(d)))


def mont_mul_lazy(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7: batched lazy Montgomery product of two (8, N) int32 limb tensors
    with values in [0, 2p); the result is in [0, 2p)."""
    _check("mont_mul_lazy", a, b)
    if a.device.type == "cpu":
        return mont_mul_lazy_plain(spec, a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"mont_mul_lazy: no kernel for device {a.device}")
    out = torch.empty_like(a)
    n = a.shape[1]
    if n == 0:
        return out
    rc = kernels.lib().pht_mont_mul_lazy(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _FIELD_IDS[spec.name],
        kernels.stream_ptr(a.device),
    )
    kernels.check(rc, "mont_mul_lazy")
    LAUNCHES["mont_mul_lazy"] += 1
    return out
