"""Host big-uint witness math: limb decompose/recompose + divmod witnesses.

Python ints play the role the reference delegates to `num_bigint`
(upstream src/paillier.rs:3, 87-97). The limb geometry here is the
*gadget* geometry (limb_bits = 64 or 88 etc.), distinct from the 8-bit device
digit geometry in ff/limbs.py.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/bignum/host.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import numpy as np


def num_limbs(bit_len: int, limb_bits: int) -> int:
    return -(-bit_len // limb_bits)


def decompose(value: int, n_limbs: int, limb_bits: int) -> list[int]:
    """Little-endian limbs of `value` (reference convention,
    upstream src/paillier.rs:24-29 folds reversed limbs MSB-first)."""
    assert value >= 0
    mask = (1 << limb_bits) - 1
    out = []
    for _ in range(n_limbs):
        out.append(value & mask)
        value >>= limb_bits
    assert value == 0, "value does not fit in n_limbs*limb_bits"
    return out


def recompose(limbs, limb_bits: int) -> int:
    acc = 0
    for v in reversed(list(limbs)):
        acc = (acc << limb_bits) + int(v)
    return acc


def decompose_array(values: np.ndarray, n_limbs: int, limb_bits: int) -> np.ndarray:
    """Vectorized: object array (m,) of ints -> object array (m, n_limbs)."""
    values = np.asarray(values, dtype=object)
    out = np.empty(values.shape + (n_limbs,), dtype=object)
    mask = (1 << limb_bits) - 1
    v = values.copy()
    for j in range(n_limbs):
        out[..., j] = [int(x) & mask for x in v.ravel()] if v.ndim else int(v) & mask
        v = np.array([int(x) >> limb_bits for x in v.ravel()], dtype=object).reshape(v.shape)
    return out


def paillier_enc_native(n: int, g: int, m: int, r: int) -> int:
    """Host oracle: c = g^m * r^n mod n^2 (upstream src/paillier.rs:87-92)."""
    n2 = n * n
    return pow(g, m, n2) * pow(r, n, n2) % n2


def paillier_add_native(n: int, c1: int, c2: int) -> int:
    """Host oracle: c1 * c2 mod n^2 (upstream src/paillier.rs:94-97)."""
    n2 = n * n
    return c1 * c2 % n2
