"""Limb-decomposed non-native big-uint gadget — re-design of the
`biguint-halo2` crate's `BigUintChip` (SURVEY.md section 2.2). API surface is
pinned by the reference's use-sites (upstream src/paillier.rs:39-81,
upstream src/bench.rs:40-116): assign_integer, square, mul, refresh
(with RefreshAux), mul_mod, pow_mod_fixed_exp, assert_equal_fresh,
extend_limbs. Limbs are little-endian, `limb_bits` wide, packed into Fr cells.

Type-state convention (mirrors the reference's Fresh/Muled):
- Fresh: every limb < 2^limb_bits, range-checked.
- Muled: limbs carry schoolbook-product overflow (< 2^max_limb_bits, not
  range-checked) and must be `refresh`ed before width-sensitive use.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/gadgets/biguint.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..bignum import host as bn
from .context import Cells, Context
from .range import RangeChip

FRESH = "fresh"
MULED = "muled"


@dataclasses.dataclass
class AssignedBigUint:
    limbs: Cells  # little-endian limb cells
    limb_bits: int
    max_limb_bits: int  # static bound on limb magnitude (== limb_bits if Fresh)
    form: str

    def num_limbs(self) -> int:
        return len(self.limbs)

    def value(self) -> int:
        """Witness value (host int) — the reference reads this via
        `get_biguint` (upstream src/paillier.rs:22-30)."""
        return bn.recompose(self.limbs.ints(), self.limb_bits)

    def extend_limbs(self, extra: int, zero: Cells) -> "AssignedBigUint":
        """Zero-pad with `extra` copies of the shared zero cell
        (upstream src/paillier.rs:49,53,79-80)."""
        if extra == 0:
            return self
        assert extra > 0
        return AssignedBigUint(
            self.limbs.concat(zero.broadcast_to(extra)),
            self.limb_bits,
            self.max_limb_bits,
            self.form,
        )


@dataclasses.dataclass(frozen=True)
class RefreshAux:
    """Carry-propagation metadata for Muled -> Fresh renormalization
    (mirrors RefreshAux::new(limb_bits, nl, nr),
    upstream src/paillier.rs:40-44)."""

    limb_bits: int
    num_limbs_l: int
    num_limbs_r: int

    @property
    def muled_limbs(self) -> int:
        return self.num_limbs_l + self.num_limbs_r - 1

    @property
    def fresh_limbs(self) -> int:
        return self.num_limbs_l + self.num_limbs_r

    @property
    def max_muled_limb_bits(self) -> int:
        overlap = min(self.num_limbs_l, self.num_limbs_r)
        return 2 * self.limb_bits + math.ceil(math.log2(overlap)) if overlap > 1 else 2 * self.limb_bits


class BigUintChip:
    """construct(range, limb_bits) mirrors BigUintChip::construct
    (upstream src/paillier.rs:131)."""

    def __init__(self, range_chip: RangeChip, limb_bits: int) -> None:
        self.range = range_chip
        self.gate = range_chip.gate
        self.ctx = range_chip.ctx
        self.limb_bits = limb_bits

    # -- assignment ----------------------------------------------------------

    def assign_integer(self, value: int, bit_len: int) -> AssignedBigUint:
        """Decompose into ceil(bit_len/limb_bits) range-checked limbs
        (use-site upstream src/paillier.rs:134-150)."""
        n = bn.num_limbs(bit_len, self.limb_bits)
        limb_vals = bn.decompose(value, n, self.limb_bits)
        limbs = self.ctx.load_witness(limb_vals)
        top_bits = bit_len - (n - 1) * self.limb_bits
        if n > 1:
            self.range.range_check(limbs[0 : n - 1], self.limb_bits)
        self.range.range_check(limbs[n - 1 : n], top_bits)
        return AssignedBigUint(limbs, self.limb_bits, self.limb_bits, FRESH)

    def assign_constant(self, value: int, n_limbs: int) -> AssignedBigUint:
        limb_vals = bn.decompose(value, n_limbs, self.limb_bits)
        limbs = self.ctx.load_constants(limb_vals)
        return AssignedBigUint(limbs, self.limb_bits, self.limb_bits, FRESH)

    # -- multiplication ------------------------------------------------------

    def mul(self, a: AssignedBigUint, b: AssignedBigUint) -> AssignedBigUint:
        """Schoolbook limb product -> Muled. Emission is vectorized: one
        mul_add block per limb of `a`, each covering all limbs of `b`."""
        assert a.form == FRESH and b.form == FRESH
        na, nb = a.num_limbs(), b.num_limbs()
        n_out = na + nb - 1
        zero = self.ctx.load_zero()
        acc = zero.broadcast_to(n_out)
        for i in range(na):
            ai = Cells(a.limbs.idx[i : i + 1], a.limbs.val[i : i + 1])
            window = Cells(acc.idx[i : i + nb], acc.val[i : i + nb])
            updated = self.gate.mul_add(ai, b.limbs, window)
            acc = Cells(
                np.concatenate([acc.idx[:i], updated.idx, acc.idx[i + nb :]]),
                np.concatenate([acc.val[:i], updated.val, acc.val[i + nb :]]),
            )
        overlap = min(na, nb)
        max_bits = 2 * self.limb_bits + (math.ceil(math.log2(overlap)) if overlap > 1 else 0)
        return AssignedBigUint(acc, self.limb_bits, max_bits, MULED)

    def square(self, a: AssignedBigUint) -> AssignedBigUint:
        """(upstream src/paillier.rs:39)"""
        return self.mul(a, a)

    # -- carry renormalization ----------------------------------------------

    def refresh(self, a: AssignedBigUint, aux: RefreshAux) -> AssignedBigUint:
        """Muled -> Fresh via witness carries, constraining
        t_k + c_k == f_k + c_{k+1} * 2^limb_bits for every position
        (upstream src/paillier.rs:45,75)."""
        assert a.form == MULED
        B = 1 << self.limb_bits
        n_out = aux.fresh_limbs
        n_in = a.num_limbs()
        assert n_out >= n_in

        value = a.value()
        fresh_vals = bn.decompose(value, n_out, self.limb_bits)
        fresh = self.ctx.load_witness(fresh_vals)
        self.range.range_check(fresh, self.limb_bits)

        # Host-compute the carry chain.
        t_vals = a.limbs.ints() + [0] * (n_out - n_in)
        carries = []
        c = 0
        for k in range(n_out):
            c = (t_vals[k] + c - fresh_vals[k]) >> self.limb_bits
            assert c >= 0
            carries.append(c)
        assert c == 0, "refresh output limbs do not absorb the value"

        zero = self.ctx.load_zero()
        carry_cells = self.ctx.load_witness(carries[:-1]) if n_out > 1 else None
        max_carry_bits = max(a.max_limb_bits - self.limb_bits + 1, 1)
        if carry_cells is not None:
            self.range.range_check(carry_cells, max_carry_bits)
            c_in = zero.concat(carry_cells)  # c_0 = 0, c_1..c_{n_out-1}
            c_out = carry_cells.concat(zero)  # c_{n_out} = 0
        else:
            c_in = zero
            c_out = zero

        # Vectorized per-position constraint:
        #   fresh_k + c_{k+1}*B == t_k + c_k
        t_cells = a.limbs.concat(zero.broadcast_to(n_out - n_in)) if n_out > n_in else a.limbs
        lhs = self.gate.mul_add(c_out, self.ctx.load_constants([B]), fresh)
        rhs = self.gate.add(t_cells, c_in)
        self.gate.assert_equal(lhs, rhs)

        return AssignedBigUint(fresh, self.limb_bits, self.limb_bits, FRESH)

    # -- modular ops ---------------------------------------------------------

    def mul_mod(
        self, a: AssignedBigUint, b: AssignedBigUint, n: AssignedBigUint
    ) -> AssignedBigUint:
        """r = a*b mod n via quotient witness: constrain a*b == q*n + r at the
        limb level (use-site upstream src/paillier.rs:57,81). As in the
        reference's dependency (halo2-rsa lineage), r is range-checked to the
        limb envelope, not to r < n; the honest witness is the true remainder."""
        assert a.form == FRESH and b.form == FRESH and n.form == FRESH
        L = n.num_limbs()
        assert a.num_limbs() == L and b.num_limbs() == L, "extend operands to modulus width"
        av, bv, nv = a.value(), b.value(), n.value()
        assert nv > 0, "mul_mod by zero modulus"
        q, r = divmod(av * bv, nv)
        Lq = L + 1
        assert q < 1 << (Lq * self.limb_bits), "quotient exceeds allocated limbs"

        q_a = self.assign_integer(q, Lq * self.limb_bits)
        r_a = self.assign_integer(r, L * self.limb_bits)

        lhs = self.mul(a, b)  # Muled, 2L-1 limbs
        qn = self.mul(q_a, n)  # Muled, 2L limbs
        # rhs = q*n + r: add r into the low L positions.
        low = self.gate.add(Cells(qn.limbs.idx[:L], qn.limbs.val[:L]), r_a.limbs)
        rhs_limbs = Cells(
            np.concatenate([low.idx, qn.limbs.idx[L:]]),
            np.concatenate([low.val, qn.limbs.val[L:]]),
        )
        rhs = AssignedBigUint(rhs_limbs, self.limb_bits, qn.max_limb_bits + 1, MULED)

        lhs_f = self.refresh(lhs, RefreshAux(self.limb_bits, L, L))
        rhs_f = self.refresh(rhs, RefreshAux(self.limb_bits, Lq, L))
        self.assert_equal_fresh(lhs_f, rhs_f)
        return r_a

    def pow_mod_fixed_exp(
        self, x: AssignedBigUint, e: int, n: AssignedBigUint
    ) -> AssignedBigUint:
        """Square-and-multiply over the *host* exponent bits — the exponent is
        a circuit-shape constant exactly as in the reference
        (upstream src/paillier.rs:50-55 reads the witness to shape the
        circuit). ~1.5 mul_mods per exponent bit."""
        L = n.num_limbs()
        if e == 0:
            return self.assign_constant(1, L)
        bits = bin(e)[2:]
        acc = x
        for bit in bits[1:]:
            acc = self.mul_mod(acc, acc, n)
            if bit == "1":
                acc = self.mul_mod(acc, x, n)
        return acc

    # -- equality ------------------------------------------------------------

    def assert_equal_fresh(self, a: AssignedBigUint, b: AssignedBigUint) -> None:
        """Limb-wise copy-constraint equality
        (upstream src/paillier.rs:164)."""
        assert a.form == FRESH and b.form == FRESH
        zero = self.ctx.load_zero()
        na, nb = a.num_limbs(), b.num_limbs()
        if na < nb:
            a = a.extend_limbs(nb - na, zero)
        elif nb < na:
            b = b.extend_limbs(na - nb, zero)
        self.gate.assert_equal(a.limbs, b.limbs)
