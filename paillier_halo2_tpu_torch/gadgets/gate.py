"""Vectorized flex-gate primitives — re-design of halo2-base's `GateChip`
(SURVEY.md section 2.2, "GateChip / flex gate").

Every public op takes/returns `Cells` vectors and emits one block of
4-rows-per-gate plus the copy/constant constraints wiring inputs in. The gate
enforced at each start row i is  w[i] + w[i+1]*w[i+2] == w[i+3]  (mod Fr).

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/gadgets/gate.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import numpy as np

from .context import FR_MOD, Cells, Context


def _mod_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([int(x) * int(y) % FR_MOD for x, y in zip(a, b)], dtype=object)


def _mod_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([(int(x) + int(y)) % FR_MOD for x, y in zip(a, b)], dtype=object)


class GateChip:
    def __init__(self, ctx: Context) -> None:
        self.ctx = ctx

    def _emit(self, w0: Cells, w1: Cells, w2: Cells, out_val: np.ndarray) -> Cells:
        """Emit gates [w0, w1, w2, out] and wire w0..w2 via copy constraints."""
        m = len(out_val)
        rows = np.empty(4 * m, dtype=object)
        rows[0::4] = w0.val
        rows[1::4] = w1.val
        rows[2::4] = w2.val
        rows[3::4] = out_val
        start = self.ctx.append_rows(rows)
        starts = start + 4 * np.arange(m, dtype=np.int64)
        self.ctx.add_gates(starts)
        self.ctx.add_copies(
            np.concatenate([starts, starts + 1, starts + 2]),
            np.concatenate([w0.idx, w1.idx, w2.idx]),
        )
        return Cells(starts + 3, out_val)

    def _bc(self, c: Cells, m: int) -> Cells:
        return c.broadcast_to(m) if len(c) == 1 and m != 1 else c

    def mul_add(self, a: Cells, b: Cells, c: Cells) -> Cells:
        """out = c + a*b (the native gate shape)."""
        m = max(len(a), len(b), len(c))
        a, b, c = self._bc(a, m), self._bc(b, m), self._bc(c, m)
        return self._emit(c, a, b, _mod_add(c.val, _mod_mul(a.val, b.val)))

    def mul(self, a: Cells, b: Cells) -> Cells:
        m = max(len(a), len(b))
        a, b = self._bc(a, m), self._bc(b, m)
        zero = self.ctx.load_zero().broadcast_to(m)
        return self._emit(zero, a, b, _mod_mul(a.val, b.val))

    def add(self, a: Cells, b: Cells) -> Cells:
        m = max(len(a), len(b))
        a, b = self._bc(a, m), self._bc(b, m)
        one = self.ctx.load_constants([1]).broadcast_to(m)
        return self._emit(a, b, one, _mod_add(a.val, b.val))

    def sub(self, a: Cells, b: Cells) -> Cells:
        m = max(len(a), len(b))
        a, b = self._bc(a, m), self._bc(b, m)
        neg_one = self.ctx.load_constants([FR_MOD - 1]).broadcast_to(m)
        out = np.array([(int(x) - int(y)) % FR_MOD for x, y in zip(a.val, b.val)], dtype=object)
        return self._emit(a, b, neg_one, out)

    def mul_const_add(self, a: Cells, k: int, c: Cells) -> Cells:
        """out = c + k*a for a host constant k."""
        m = max(len(a), len(c))
        a, c = self._bc(a, m), self._bc(c, m)
        kc = self.ctx.load_constants([k % FR_MOD]).broadcast_to(m)
        out = np.array(
            [(int(cv) + k * int(av)) % FR_MOD for av, cv in zip(a.val, c.val)], dtype=object
        )
        return self._emit(c, a, kc, out)

    def assert_equal(self, a: Cells, b: Cells) -> None:
        """Copy-constraint equality (permutation argument semantics, the
        mechanism behind assert_equal_fresh, upstream src/paillier.rs:164).

        Constraint-only, like halo2's constrain_equal [dep]: unequal witness
        values synthesize fine and are caught by the MockProver's copy check
        (or a non-closing permutation product in the real prover) — a hard
        synthesis-time assert here would make unsatisfiable circuits
        untestable. The reference's harness-level double-assert (witness
        assert_eq AND constraint, upstream src/bench.rs:58-74) lives
        in harness/circuits.py, not in the gate."""
        assert len(a) == len(b)
        self.ctx.add_copies(a.idx, b.idx)
