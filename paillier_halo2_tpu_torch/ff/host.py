"""Host-side (Python-int) BN254 field and curve constants + scalar modular math.

Role: the host oracle layer. The reference leans on `halo2curves` for BN254
Fr/Fq arithmetic (SURVEY.md section 2.2); on the host side we use Python's
arbitrary-precision ints, mirroring the reference's use of `num_bigint`
(upstream src/paillier.rs:87-97). The vectorized device counterpart lives in
`ff/field.py`; every device op is tested against these functions.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/ff/host.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

# BN254 (alt_bn128) scalar field modulus (order of G1) — the witness field Fr.
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field modulus Fq.
FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# 2-adicity of Fr - 1: Fr has multiplicative subgroups of order 2^k for k <= 28.
FR_TWO_ADICITY = 28
# Generator of Fr* (smallest): 5 generates the full multiplicative group.
FR_GENERATOR = 5
# Primitive 2^28-th root of unity: FR_GENERATOR ** ((FR_MOD-1) >> 28).
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MOD - 1) >> FR_TWO_ADICITY, FR_MOD)

# G1: y^2 = x^3 + 3 over Fq; generator (1, 2).
G1_GEN = (1, 2)
B_G1 = 3

# G2: y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1). Generator coordinates are the
# standard alt_bn128 values (each Fq2 element given as (c0, c1): c0 + c1*u).
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def inv_mod(a: int, m: int) -> int:
    """Modular inverse via Python's built-in (extended Euclid under the hood)."""
    return pow(a, -1, m)


def fr(x: int) -> int:
    return x % FR_MOD


def fq(x: int) -> int:
    return x % FQ_MOD


def root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr."""
    assert 0 <= k <= FR_TWO_ADICITY
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), FR_MOD)
