"""K1: batched Montgomery multiplication — the wrapper around the CUDA kernel
`csrc/mont_mul.cu` and its plain PyTorch version.

Counterpart of `paillier_halo2_tpu/ff/pallas_mulmod.py:372`
(`mont_mul_pallas`). Operands are `(8, N)` int32 tensors holding the uint32
limbs of canonical Montgomery values; the result is a*b*2^-256 mod p, also
canonical. On a CUDA tensor `mont_mul` launches the kernel (at every lane
count) or raises; on a CPU tensor it runs `mont_mul_plain`. Nothing falls back.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from .limbs16 import M16, M32, to_i32, u64

LAUNCHES = {"mont_mul": 0}
_FIELD_IDS = {"Fr": 0, "Fq": 1}


def redc_plain(spec, a: torch.Tensor, b: torch.Tensor):
    """u = (a*b + m*p) / R with m = -a*b*p^-1 mod R, for (8, N) int32 limb
    tensors a, b below R, in plain torch: CIOS with a's 32-bit limbs times
    b's 16-bit half-limbs, accumulated in int64 16-bit columns with lazy
    carries (each column stays below 2^53), then one exact carry pass.
    Returns u's eight 32-bit limbs as int64 (N,) tensors and its bit 256
    (u < R + p). The value is unique, so it is the one the kernels' 32-bit
    CIOS computes."""
    n = a.shape[1]
    a32 = u64(a)  # (8, N)
    bu = u64(b)
    b16 = torch.stack([bu & M16, bu >> 16], dim=1).reshape(16, n)
    p32 = spec.const32(a.device)  # (8, 1) int64
    inv16 = spec.inv16
    t = torch.zeros((33, n), dtype=torch.int64, device=a.device)
    for j in range(16):
        w = t[j : j + 16 : 2]  # columns j, j+2, ..., j+14
        w.addcmul_(a32, b16[j])
        m = ((t[j] & M16) * inv16) & M16
        w.addcmul_(p32, m)
        t[j + 1] += t[j] >> 16  # column j is now 0 mod 2^16
    # t[16:33] are the 16-bit columns of u (each below 2^53)
    c = t[16] >> 16
    lo = t[16] & M16
    u = []
    for k in range(8):
        v = t[17 + 2 * k] + c
        u.append(lo | ((v & M16) << 16))
        v = t[18 + 2 * k] + (v >> 16)
        lo, c = v & M16, v >> 16
    return u, lo  # lo: bit 256 of u


def mont_mul_plain(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: u = `redc_plain(a, b)`, minus p
    once if u >= p. Works on any device; the wrapper takes it for CPU
    tensors."""
    u, top = redc_plain(spec, a, b)
    d, bw = [], 0
    for k in range(8):
        x = u[k] - spec.p_limbs[k] - bw
        d.append(x & M32)
        bw = (x >> 32) & 1
    ge = (top != 0) | (bw == 0)
    return to_i32(torch.where(ge, torch.stack(d), torch.stack(u)))


def _check(name: str, *ts: torch.Tensor) -> None:
    ref = ts[0]
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != 8:
            raise ValueError(f"{name}: expected shape (8, N), got {tuple(t.shape)}")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(ref.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def mont_mul(spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Montgomery product of two (8, N) int32 limb tensors."""
    _check("mont_mul", a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"mont_mul: no kernel for device {a.device}")
    out = torch.empty_like(a)
    n = a.shape[1]
    if n == 0:
        return out
    rc = kernels.lib().pht_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _FIELD_IDS[spec.name],
        kernels.stream_ptr(a.device),
    )
    kernels.check(rc, "mont_mul")
    LAUNCHES["mont_mul"] += 1
    return out
