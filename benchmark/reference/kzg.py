"""KZG commitments worked out from the SRS's secret.

The SRS of a run is the dev-mode powers of tau, tau derived from the run's
seed bytes (the program's published rule, written out again here). A
commitment to p is [p(tau)]G1 however it is computed, so the reference
evaluates p at tau in Fr and makes one scalar multiplication: the same
point the program's MSM must give, reached by another road.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .bn254 import G1, MONT_R_INV, R, mul, root_of_unity

TAU_DOMAIN = b"paillier-tpu-dev-srs"


def dev_tau(seed: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(TAU_DOMAIN + seed).digest(), "little") % R


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """(8, m) 32-bit little-endian limbs (any integer dtype) as Python ints."""
    rows = np.ascontiguousarray(np.asarray(limbs).astype(np.uint32).T)  # (m, 8)
    raw = rows.tobytes()
    return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]


def eval_monomial(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def commit_monomial_mont(mont_coeffs: list[int], tau: int, truncate_bits: int | None = None):
    """Commitment to the polynomial whose coefficients are given in
    Montgomery form (c_i * 2^256 mod r). `truncate_bits` keeps only the low
    bits of each standard-form coefficient: the control's broken guarantee."""
    if truncate_bits is None:
        return mul(G1, eval_monomial(mont_coeffs, tau) * MONT_R_INV % R)
    mask = (1 << truncate_bits) - 1
    std = [c * MONT_R_INV % R & mask for c in mont_coeffs]
    return mul(G1, eval_monomial(std, tau))


def lagrange_at(tau: int, k: int) -> list[int]:
    """L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i)) for i < n = 2^k."""
    n = 1 << k
    w = root_of_unity(k)
    wp = [1] * n
    for i in range(1, n):
        wp[i] = wp[i - 1] * w % R
    den = [n * (tau - wi) % R for wi in wp]
    pref = [1] * (n + 1)
    for i, d in enumerate(den):
        pref[i + 1] = pref[i] * d % R
    inv = pow(pref[n], -1, R)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = inv * pref[i] % R
        inv = inv * den[i] % R
    zt = (pow(tau, n, R) - 1) % R
    return [wp[i] * zt % R * invs[i] % R for i in range(n)]


def eval_lagrange(values, basis: list[int]) -> int:
    return sum(int(v) * b for v, b in zip(values, basis)) % R


def commit_lagrange(values, basis: list[int]):
    """Commitment to the polynomial taking `values` on the domain."""
    return mul(G1, eval_lagrange(values, basis))
