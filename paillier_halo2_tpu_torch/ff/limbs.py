"""Host <-> digit-array conversion for the reference's 8-bit digit format.

A 256-bit field element is represented in the JAX package as 32 little-endian digits of
8 bits each, held in uint32 lanes. 8-bit digits are chosen so that schoolbook
digit products (<= 2^16) can be accumulated across all 32 positions (< 2^21)
without overflowing a 32-bit lane — the representation that lets multiplication
become convolutions/matmuls (MXU food) instead of carry-serial scalar code.
(the JAX package's replacement for halo2curves' 4x64-bit Montgomery arithmetic,
SURVEY.md section 2.2.)

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/ff/limbs.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import numpy as np

DIGIT_BITS = 8
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1
N_DIGITS = 32  # 32 * 8 = 256 bits


def int_to_digits(x: int, n_digits: int = N_DIGITS) -> np.ndarray:
    """Little-endian 8-bit digits of a nonnegative int, as uint32[n_digits]."""
    assert x >= 0
    out = np.zeros(n_digits, dtype=np.uint32)
    i = 0
    while x:
        assert i < n_digits, "value does not fit in n_digits"
        out[i] = x & DIGIT_MASK
        x >>= DIGIT_BITS
        i += 1
    return out


def digits_to_int(d) -> int:
    """Fold a little-endian digit vector (any per-digit magnitude) to an int."""
    d = np.asarray(d)
    acc = 0
    for v in reversed(d.tolist()):
        acc = (acc << DIGIT_BITS) + int(v)
    return acc


def ints_to_digits(xs, n_digits: int = N_DIGITS) -> np.ndarray:
    """Batch conversion: list of ints -> uint32[len(xs), n_digits]."""
    out = np.zeros((len(xs), n_digits), dtype=np.uint32)
    for i, x in enumerate(xs):
        out[i] = int_to_digits(x, n_digits)
    return out


def digits_to_ints(arr) -> list[int]:
    """Batch conversion back: (..., n_digits) -> flat list of ints (row-major)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    return [digits_to_int(row) for row in flat]
