"""Vectorized BN254 prime-field arithmetic on limb tensors.

Counterpart of `paillier_halo2_tpu/ff/field_jax.py:1`. The number format,
decided here for the whole port:

- a field element is 8 little-endian 32-bit limbs, stored limb-first as
  `(8, *batch)` `torch.int32` tensors holding uint32 bit patterns;
- Montgomery form uses R = 2^256 for Fr and Fq alike, as the JAX package does,
  so Montgomery values agree across packages;
- limb k holds the JAX package's 8-bit digits 4k..4k+3 — the word layout of
  its `pack_points_dense` (`paillier_halo2_tpu/ec/bn254.py:228-237`).
  `from_ref_digits` / `to_ref_digits` convert between the JAX package's
  `(32, *batch)` uint32 digit arrays and this layout.

`mont_mul` goes through K1 (`ff/mulmod.py`): the CUDA kernel on a CUDA
tensor, its plain torch version on a CPU tensor. Additions, subtractions and
selects are plain torch on int64-widened limbs, as the JAX package left them
to XLA.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import host, mulmod
from .limbs16 import M32, to_i32, u64

N_LIMBS = 8
R_BITS = 256


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Per-field constants (host ints) plus per-device tensor caches."""

    p: int
    name: str

    @functools.cached_property
    def r_mod_p(self) -> int:
        return (1 << R_BITS) % self.p

    @functools.cached_property
    def p_limbs(self) -> tuple[int, ...]:
        return tuple((self.p >> (32 * k)) & M32 for k in range(N_LIMBS))

    @functools.cached_property
    def _cache(self) -> dict:
        return {}

    def limbs(self, which: str, device) -> torch.Tensor:
        """(8,) int32 tensor of a constant: "p", "one" (1), "one_mont" (R mod
        p) or "r2" (R^2 mod p)."""
        key = ("limbs", which, str(device))
        if key not in self._cache:
            val = {
                "p": self.p,
                "one": 1,
                "one_mont": self.r_mod_p,
                "r2": self.r_mod_p * self.r_mod_p % self.p,
            }[which]
            self._cache[key] = pack_ints([val], device)[:, 0]
        return self._cache[key]

    @functools.cached_property
    def inv16(self) -> int:
        """-p^-1 mod 2^16 (the plain multiply's per-column REDC factor)."""
        return (-pow(self.p, -1, 1 << 16)) % (1 << 16)

    def const32(self, device) -> torch.Tensor:
        """(8, 1) int64 tensor of p's 32-bit limbs (plain multiply)."""
        key = ("p32", str(device))
        if key not in self._cache:
            self._cache[key] = torch.tensor(self.p_limbs, dtype=torch.int64, device=device)[:, None]
        return self._cache[key]


FR = FieldSpec(host.FR_MOD, "Fr")
FQ = FieldSpec(host.FQ_MOD, "Fq")


def _bcast(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """(8,) constant -> (8, 1, ..., 1) for limb-first broadcasting."""
    return c.reshape((N_LIMBS,) + (1,) * (ndim - 1))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Per-element a == 0 (the limb axis is reduced)."""
    return (a == 0).all(dim=0)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b."""
    a, b = torch.broadcast_tensors(a, b)
    ua, ub = u64(a), u64(b)
    s, c = [], 0
    for k in range(N_LIMBS):
        v = ua[k] + ub[k] + c
        s.append(v & M32)
        c = v >> 32
    d, bw = [], 0
    for k in range(N_LIMBS):
        x = s[k] - spec.p_limbs[k] - bw
        d.append(x & M32)
        bw = (x >> 32) & 1
    use_d = (c != 0) | (bw == 0)
    return to_i32(torch.where(use_d, torch.stack(d), torch.stack(s)))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical a, b."""
    a, b = torch.broadcast_tensors(a, b)
    ua, ub = u64(a), u64(b)
    d, bw = [], 0
    for k in range(N_LIMBS):
        x = ua[k] - ub[k] - bw
        d.append(x & M32)
        bw = (x >> 32) & 1
    out, c = [], 0
    for k in range(N_LIMBS):
        v = d[k] + spec.p_limbs[k] * bw + c
        out.append(v & M32)
        c = v >> 32
    return to_i32(torch.stack(out))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    p = _bcast(spec.limbs("p", a.device), a.dim())
    return torch.where(is_zero(a), a, sub(spec, p.expand_as(a), a))


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p on broadcastable (8, *batch) limb
    tensors. Every call goes through K1 (flattened to (8, lanes))."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    lanes = math.prod(batch)
    shape = (N_LIMBS,) + tuple(batch)
    af = a.expand(shape).reshape(N_LIMBS, lanes).contiguous()
    bf = b.expand(shape).reshape(N_LIMBS, lanes).contiguous()
    return mulmod.mont_mul(spec, af, bf).reshape(shape)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, _bcast(spec.limbs("r2", a.device), a.dim()))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, _bcast(spec.limbs("one", a.device), a.dim()))


def mont_pow_fixed(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a in Montgomery form and a host exponent e (square-and-multiply,
    MSB first)."""
    acc = _bcast(spec.limbs("one_mont", a.device), a.dim()).expand_as(a).contiguous()
    if e == 0:
        return acc
    for bit in bin(e)[2:]:
        acc = mont_sqr(spec, acc)
        if bit == "1":
            acc = mont_mul(spec, acc, a)
    return acc


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse via Fermat, a^(p-2); Montgomery in and out (0 -> 0)."""
    return mont_pow_fixed(spec, a, spec.p - 2)


# -- host <-> device -----------------------------------------------------------


def pack_ints(xs, device) -> torch.Tensor:
    """Sequence of nonnegative ints < 2^256 -> (8, len(xs)) int32 limbs."""
    xs = list(xs)
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype=np.uint32).reshape(len(xs), N_LIMBS)
    return torch.from_numpy(arr.T.copy().view(np.int32)).to(device)


def unpack_ints(t: torch.Tensor) -> list[int]:
    """(8, *batch) limbs -> flat list of ints (row-major over the batch)."""
    a = t.detach().to("cpu").contiguous().reshape(N_LIMBS, -1).numpy().view(np.uint32)
    raw = np.ascontiguousarray(a.T).tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(a.shape[1])]


def from_ref_digits(d, device) -> torch.Tensor:
    """JAX-package digits (32, *batch) uint32 (8-bit each) -> (8, *batch) limbs."""
    d = np.asarray(d).astype(np.uint32)
    w = d.reshape((N_LIMBS, 4) + d.shape[1:])
    limbs = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32)).to(device)


def from_lazy_digits(spec: FieldSpec, d, device) -> torch.Tensor:
    """JAX-package lazy digits (32, N) — signed base-256 digits held as int16
    or f32, value sum_i d_i 256^i, possibly negative or above p
    (`paillier_halo2_tpu/ff/lazy_mont.py:10-19`) -> (8, N) limbs of that
    value mod p, canonical. The lazy counterpart of `from_ref_digits`."""
    d = np.asarray(d).astype(np.int64)
    digits = np.empty(d.shape, np.uint8)
    carry = np.zeros(d.shape[1:], np.int64)
    for i in range(d.shape[0]):  # signed carry pass: digits to [0, 255]
        v = d[i] + carry
        digits[i] = v & 0xFF
        carry = v >> 8  # floor division: the carry keeps the sign
    raw = np.ascontiguousarray(digits.T).tobytes()
    n = d.shape[1]
    vals = [
        (int.from_bytes(raw[32 * j : 32 * j + 32], "little") + (int(carry[j]) << 256)) % spec.p
        for j in range(n)
    ]
    return pack_ints(vals, device)


def to_ref_digits(t: torch.Tensor) -> np.ndarray:
    """(8, *batch) limbs -> JAX-package digits (32, *batch) uint32."""
    u = t.detach().to("cpu").contiguous().numpy().view(np.uint32)
    parts = [(u >> np.uint32(8 * j)) & np.uint32(0xFF) for j in range(4)]
    return np.stack(parts, axis=1).reshape((32,) + u.shape[1:]).astype(np.uint32)
