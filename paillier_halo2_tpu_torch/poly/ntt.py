"""Radix-2 NTT/iNTT over Fr on limb tensors.

Counterpart of `paillier_halo2_tpu/poly/ntt.py:1` (the unrolled stage form):
a bit-reversal gather, then k Cooley-Tukey DIT butterfly stages — each one
batched Montgomery product (K1) over n/2 lanes per polynomial plus an add and
a sub — and the 1/n scaling for the inverse. The bit-reversal index, the
per-stage twiddles and 1/n are built once per (k, direction, device) and stay
resident on the device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import field as f
from ..ff import host

N_LIMBS = 8


@functools.lru_cache(maxsize=None)
def _bitrev(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _powers(base: int, count: int) -> list[int]:
    acc, out = 1, []
    for _ in range(count):
        out.append(acc)
        acc = acc * base % host.FR_MOD
    return out


@functools.lru_cache(maxsize=None)
def _tables(k: int, inverse: bool, device: str):
    """(bit-reversal index, per-stage twiddles (8, 2^s) Montgomery, 1/n)."""
    p = host.FR_MOD
    rmod = f.FR.r_mod_p
    tws = []
    for s in range(k):
        w = host.root_of_unity(s + 1)
        if inverse:
            w = pow(w, p - 2, p)
        tws.append(f.pack_ints([x * rmod % p for x in _powers(w, 1 << s)], device))
    n_inv = pow(1 << k, p - 2, p)
    scale = f.pack_ints([n_inv * rmod % p], device)[:, 0]
    rev = torch.from_numpy(_bitrev(k)).to(device)
    return rev, tuple(tws), scale


def ntt(x: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """In-order NTT along the LAST axis of an (8, ..., 2^k) Montgomery tensor;
    middle axes batch independent polynomials.

    Forward: evaluations over H in natural order (omega^i at index i).
    Inverse: includes the 1/n scaling."""
    n = 1 << k
    assert x.shape[0] == N_LIMBS and x.shape[-1] == n, x.shape
    batch = tuple(x.shape[1:-1])
    ones = (1,) * len(batch)
    rev, tws, scale = _tables(k, inverse, str(x.device))
    x = x.index_select(-1, rev)
    for s, tw in enumerate(tws):
        half = 1 << s
        xb = x.reshape((N_LIMBS,) + batch + (n >> (s + 1), 2, half))
        u = xb[..., 0, :]
        v = f.mont_mul(f.FR, xb[..., 1, :], tw.reshape((N_LIMBS,) + ones + (1, half)))
        x = torch.stack([f.add(f.FR, u, v), f.sub(f.FR, u, v)], dim=-2)
        x = x.reshape((N_LIMBS,) + batch + (n,))
    if inverse:
        x = f.mont_mul(f.FR, x, scale.reshape((N_LIMBS,) + ones + (1,)))
    return x


# -- host oracle -------------------------------------------------------------


def ntt_host(coeffs: list[int], k: int, inverse: bool = False) -> list[int]:
    """Python-int radix-2 NTT oracle for tests (as `poly/ntt.py:152`)."""
    p = host.FR_MOD
    n = 1 << k
    assert len(coeffs) == n
    a = [c % p for c in coeffs]
    a = [a[i] for i in _bitrev(k)]
    for s in range(k):
        half = 1 << s
        w = host.root_of_unity(s + 1)
        if inverse:
            w = pow(w, p - 2, p)
        ws = _powers(w, half)
        for start in range(0, n, 2 * half):
            for j in range(half):
                u = a[start + j]
                v = a[start + half + j] * ws[j] % p
                a[start + j] = (u + v) % p
                a[start + half + j] = (u - v) % p
    if inverse:
        n_inv = pow(n, p - 2, p)
        a = [x * n_inv % p for x in a]
    return a
