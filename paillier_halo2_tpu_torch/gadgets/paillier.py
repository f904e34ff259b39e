"""Paillier gadget layer — re-design of the reference's application layer
(upstream src/paillier.rs:6-97). Same semantics, cell for cell:

- encrypt: c = g^m * r^n mod n^2 with the exponents read from witness values
  (circuit-shape constants), n^2 recomputed via square+refresh each call.
- add: c1 * c2 mod n^2, n^2 likewise recomputed
  (upstream src/paillier.rs:69-75 does not cache n^2).

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/gadgets/paillier.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import dataclasses

from ..bignum.host import paillier_add_native, paillier_enc_native  # re-export
from .biguint import AssignedBigUint, BigUintChip, RefreshAux

__all__ = [
    "EncryptionPublicKeyAssigned",
    "PaillierChip",
    "paillier_enc_native",
    "paillier_add_native",
]


@dataclasses.dataclass
class EncryptionPublicKeyAssigned:
    """(upstream src/paillier.rs:6-9)"""

    n: AssignedBigUint
    g: AssignedBigUint


class PaillierChip:
    """(upstream src/paillier.rs:11-20)"""

    def __init__(self, biguint: BigUintChip, enc_bits: int) -> None:
        self.biguint = biguint
        self.enc_bits = enc_bits

    @classmethod
    def construct(cls, biguint: BigUintChip, enc_bits: int) -> "PaillierChip":
        return cls(biguint, enc_bits)

    def get_biguint(self, assigned: AssignedBigUint) -> int:
        """Fold limb witness values MSB-first
        (upstream src/paillier.rs:22-30)."""
        acc = 0
        for v in reversed(assigned.limbs.ints()):
            acc = (acc << assigned.max_limb_bits) + v
        return acc

    def _n_squared(self, n: AssignedBigUint) -> AssignedBigUint:
        n2 = self.biguint.square(n)
        aux = RefreshAux(self.biguint.limb_bits, n.num_limbs(), n.num_limbs())
        return self.biguint.refresh(n2, aux)

    def encrypt(
        self,
        pk_enc: EncryptionPublicKeyAssigned,
        m: AssignedBigUint,
        r: AssignedBigUint,
    ) -> AssignedBigUint:
        """(upstream src/paillier.rs:32-60)"""
        n2 = self._n_squared(pk_enc.n)
        zero = self.biguint.ctx.load_zero()

        g_ext = pk_enc.g.extend_limbs(n2.num_limbs() - pk_enc.g.num_limbs(), zero)
        m_int = self.get_biguint(m)
        gm = self.biguint.pow_mod_fixed_exp(g_ext, m_int, n2)

        r_ext = r.extend_limbs(n2.num_limbs() - r.num_limbs(), zero)
        n_int = self.get_biguint(pk_enc.n)
        rn = self.biguint.pow_mod_fixed_exp(r_ext, n_int, n2)

        return self.biguint.mul_mod(gm, rn, n2)

    def add(
        self,
        pk_enc: EncryptionPublicKeyAssigned,
        c1: AssignedBigUint,
        c2: AssignedBigUint,
    ) -> AssignedBigUint:
        """(upstream src/paillier.rs:62-84)"""
        n2 = self._n_squared(pk_enc.n)
        zero = self.biguint.ctx.load_zero()
        c1_ext = c1.extend_limbs(n2.num_limbs() - c1.num_limbs(), zero)
        c2_ext = c2.extend_limbs(n2.num_limbs() - c2.num_limbs(), zero)
        return self.biguint.mul_mod(c1_ext, c2_ext, n2)
