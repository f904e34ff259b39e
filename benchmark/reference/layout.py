"""The circuit's column layout and the verifying key, worked out again from
a synthesized table's structure.

A frozen copy of the layout rule the prover publishes (halo2-base's
RangeCircuitBuilder assignment as the program implements it): the single
virtual column split column-major into advice columns of height 2^k, a
4-row gate never split, the last BLINDING_ROWS rows of every column kept
for blinding, lookup cells copied into lookup columns, constants into one
fixed column, and the copy classes walked in ascending cell order into the
permutation. The key's commitments are then made from tau (`kzg.py`), not
read from the program.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from .bn254 import DELTA, R, root_of_unity
from .kzg import commit_lagrange

BLINDING_ROWS = 10
PERM_CHUNK = 2


@dataclasses.dataclass
class Layout:
    k: int
    lookup_bits: int
    num_advice: int
    num_lookup_advice: int
    col_of: np.ndarray
    row_of: np.ndarray
    q: np.ndarray  # (num_advice, n) 0/1
    fixed_const: np.ndarray  # (n,) object
    sigma_col: np.ndarray  # (n_perm_cols, n)
    sigma_row: np.ndarray
    lookup_src: np.ndarray  # (num_lookup_advice, n), -1 unused

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def usable(self) -> int:
        return self.n - BLINDING_ROWS

    @property
    def n_perm_cols(self) -> int:
        return self.num_advice + self.num_lookup_advice + 1

    @property
    def perm_chunks(self) -> list[list[int]]:
        npc = self.n_perm_cols
        return [list(range(s, min(s + PERM_CHUNK, npc))) for s in range(0, npc, PERM_CHUNK)]


def assign(table, k: int, lookup_bits: int) -> Layout:
    """Layout of `table` (fields `values`, `gates`, `copy_a`, `copy_b`,
    `const_idx`, `const_val`, `lookups`; no public inputs)."""
    n = 1 << k
    usable = n - BLINDING_ROWS
    n_virtual = len(table.values)
    gate_starts = np.sort(np.asarray(table.gates, dtype=np.int64))
    cov = np.zeros(n_virtual + 1, dtype=np.int64)
    np.add.at(cov, gate_starts, 1)
    np.add.at(cov, np.minimum(gate_starts + 4, n_virtual), -1)
    inside = np.cumsum(cov[:-1]) > 0
    is_gs = np.zeros(n_virtual + 1, dtype=bool)
    is_gs[gate_starts] = True
    starts = np.sort(np.concatenate([gate_starts, np.nonzero(~inside)[0]]))
    sizes = np.where(is_gs[starts], 4, 1).astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(sizes)])
    if prefix[-1] != n_virtual:
        raise ValueError("gate blocks overlap")
    n_blocks = len(starts)
    cols_blocks = np.zeros(n_blocks, dtype=np.int64)
    col_base = np.zeros(n_blocks, dtype=np.int64)
    j0, col = 0, 0
    while j0 < n_blocks:
        j1 = int(np.searchsorted(prefix, prefix[j0] + usable, side="right")) - 1
        cols_blocks[j0:j1] = col
        col_base[j0:j1] = prefix[j0]
        col += 1
        j0 = j1
    col_of = np.repeat(cols_blocks, sizes)
    row_of = np.repeat(prefix[:n_blocks] - col_base, sizes) + (
        np.arange(n_virtual) - np.repeat(prefix[:n_blocks], sizes))
    na = col

    q = np.zeros((na, n), dtype=np.uint8)
    q[col_of[gate_starts], row_of[gate_starts]] = 1

    lookups = np.asarray(table.lookups, dtype=np.int64)
    nl = -(-len(lookups) // usable)
    lookup_src = np.full((nl, n), -1, dtype=np.int64)
    for j, vrow in enumerate(lookups):
        lc, lr = divmod(j, usable)
        lookup_src[lc, lr] = vrow

    # constants: one fixed cell per distinct value, in order of first appearance
    fixed_const = np.zeros(n, dtype=object)
    const_idx = np.asarray(table.const_idx, dtype=np.int64)
    const_vals = [int(v) for v in table.const_val]
    slot: dict[int, int] = {}
    for v in const_vals:
        if v not in slot:
            slot[v] = len(slot)
            fixed_const[slot[v]] = v
    const_pos = np.array([slot[v] for v in const_vals], dtype=np.int64)

    npc = na + nl + 1
    fixed_col = na + nl
    vcells = col_of * n + row_of
    lc_idx, lr_idx = np.nonzero(lookup_src >= 0)
    ea = np.concatenate([vcells[np.asarray(table.copy_a, dtype=np.int64)], vcells[const_idx],
                         vcells[lookup_src[lc_idx, lr_idx]]])
    eb = np.concatenate([vcells[np.asarray(table.copy_b, dtype=np.int64)],
                         fixed_col * n + const_pos, (na + lc_idx) * n + lr_idx])
    sigma = np.arange(npc * n, dtype=np.int64)
    if len(ea):
        import scipy.sparse
        from scipy.sparse.csgraph import connected_components

        cells = np.unique(np.concatenate([ea, eb]))
        m = len(cells)
        graph = scipy.sparse.coo_matrix(
            (np.ones(len(ea), dtype=np.int8), (np.searchsorted(cells, ea), np.searchsorted(cells, eb))),
            shape=(m, m))
        _, labels = connected_components(graph, directed=False)
        order = np.lexsort((cells, labels))
        sc, sl = cells[order], labels[order]
        is_start = np.r_[True, sl[1:] != sl[:-1]]
        grp_start = sc[np.maximum.accumulate(np.where(is_start, np.arange(m), 0))]
        nxt = np.r_[sc[1:], np.int64(-1)]
        is_last = np.r_[is_start[1:], True]
        nxt[is_last] = grp_start[is_last]
        sigma[sc] = nxt
    return Layout(k, lookup_bits, na, nl, col_of, row_of, q, fixed_const,
                  (sigma // n).reshape(npc, n), (sigma % n).reshape(npc, n), lookup_src)


def same_structure(a, b) -> bool:
    """Whether two tables have one circuit shape (all but the values)."""
    return len(a.values) == len(b.values) and all(
        np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
        for f in ("gates", "copy_a", "copy_b", "const_idx", "lookups")
    ) and [int(v) for v in a.const_val] == [int(v) for v in b.const_val]


@dataclasses.dataclass
class VerifyingKey:
    layout: Layout
    q_commits: list
    fixed_const_commit: tuple
    table_commit: tuple
    sigma_commits: list

    def fixed_commitments(self) -> list:
        return [*self.q_commits, self.fixed_const_commit, self.table_commit, *self.sigma_commits]


def verifying_key(layout: Layout, basis: list[int]) -> VerifyingKey:
    """The key's commitments, each [p(tau)]G1 from the column's values."""
    n = layout.n
    w = root_of_unity(layout.k)
    omega = [1] * n
    for i in range(1, n):
        omega[i] = omega[i - 1] * w % R
    deltas = [pow(DELTA, j, R) for j in range(layout.n_perm_cols)]
    table_vals = list(range(1 << layout.lookup_bits)) + [0] * (n - (1 << layout.lookup_bits))
    sigmas = [[deltas[c] * omega[r] % R for c, r in zip(layout.sigma_col[j].tolist(), layout.sigma_row[j].tolist())]
              for j in range(layout.n_perm_cols)]
    return VerifyingKey(
        layout,
        [commit_lagrange(layout.q[c].tolist(), basis) for c in range(layout.num_advice)],
        commit_lagrange(layout.fixed_const, basis),
        commit_lagrange(table_vals, basis),
        [commit_lagrange(s, basis) for s in sigmas],
    )


def _blind(seed: bytes, tag: bytes, r: int) -> int:
    return int.from_bytes(hashlib.blake2b(seed + tag + r.to_bytes(4, "little")).digest(), "little") % R


def witness_columns(table, layout: Layout, blinding_seed: bytes) -> tuple[list, list]:
    """The advice and lookup columns a proof with `blinding_seed` commits:
    the table's values in place, the blinding rows drawn from the seed."""
    n, usable = layout.n, layout.usable
    vals = np.asarray(table.values, dtype=object)
    adv = np.zeros((layout.num_advice, n), dtype=object)
    adv[layout.col_of, layout.row_of] = vals
    for c in range(layout.num_advice):
        for r in range(usable, n):
            adv[c, r] = _blind(blinding_seed, b"blind" + bytes([c]), r)
    lk = np.zeros((layout.num_lookup_advice, n), dtype=object)
    mask = layout.lookup_src >= 0
    lk[mask] = vals[layout.lookup_src[mask]]
    for i in range(layout.num_lookup_advice):
        for r in range(usable, n):
            lk[i, r] = _blind(blinding_seed, b"lk%d" % i, r)
    return adv.tolist(), lk.tolist()
