"""Column assignment: virtual table -> PLONKish circuit layout.

Re-design of halo2-base's RangeCircuitBuilder assignment step (SURVEY.md
section 2.2, "Context / SinglePhaseCoreManager / RangeCircuitBuilder"): the
single virtual column is split column-major into `num_advice` columns of
height 2^k, with two layout invariants the prover depends on:

1. a 4-row gate block never straddles a column boundary (gates constrain
   rotations within one column), enforced by padding to the next column when
   a block would split;
2. the bottom BLINDING_ROWS of every column are reserved for blinding.

Lookup-tagged cells are replicated (via copy constraint) into dedicated
lookup-advice columns, halo2-base style, so the lookup argument runs over
whole columns against the fixed range table.

Outputs a `CircuitLayout` with: per-column witness digit arrays, the selector
column, the fixed constant column, permutation cycles over (column, row)
cells, and lookup column assignments.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/plonk/layout.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..gadgets.context import VirtualTable
from .params import BLINDING_ROWS, ConfigParams


@dataclasses.dataclass
class CircuitLayout:
    config: ConfigParams
    n: int  # 2^k
    # virtual row -> (column, row) mapping
    col_of: np.ndarray  # (n_virtual,)
    row_of: np.ndarray  # (n_virtual,)
    # selector: per advice column, rows where a gate starts
    q: np.ndarray  # (num_advice, n) uint8
    # fixed constant column: value per row (object ints), and for each constant
    # cell the (col,row) it is copy-linked to is folded into the permutation
    fixed_const: np.ndarray  # (n,) object
    # permutation cycles: for every cell in a copy-equivalence class, its
    # successor cell (sigma), over columns = [advice..., lookup_advice..., fixed]
    sigma_col: np.ndarray  # (n_perm_cols, n)
    sigma_row: np.ndarray  # (n_perm_cols, n)
    # lookup advice columns: source virtual rows feeding each (col, row) slot
    lookup_src: np.ndarray  # (num_lookup_advice, n) int64, -1 = unused (0 value)
    n_virtual: int
    # public-input (instance) column: source virtual rows, in exposure order
    # (empty = no instance column; the reference's tests use none)
    publics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )

    @property
    def num_advice(self) -> int:
        return self.config.num_advice

    @property
    def num_lookup_advice(self) -> int:
        return self.config.num_lookup_advice

    @property
    def num_instance(self) -> int:
        return 1 if len(self.publics) else 0

    @property
    def n_perm_cols(self) -> int:
        # + fixed column (+ instance column when publics are exposed)
        return self.num_advice + self.num_lookup_advice + 1 + self.num_instance


def assign_layout(table: VirtualTable, k: int, lookup_bits: int) -> CircuitLayout:
    n = 1 << k
    usable = n - BLINDING_ROWS
    n_virtual = table.n_rows

    # ---- place virtual rows into columns, never splitting a gate block ----
    # Vectorized block walk (the scalar loop was O(n_virtual) Python — too
    # slow past ~10M cells): a block is the 4 rows of a gate or a single
    # non-gate row; greedy per-column packing via searchsorted over the block
    # prefix sums.
    gate_starts = np.sort(table.gates)
    cov = np.zeros(n_virtual + 1, dtype=np.int8)
    np.add.at(cov, gate_starts, 1)
    np.add.at(cov, np.minimum(gate_starts + 4, n_virtual), -1)
    inside = np.cumsum(cov[:-1]) > 0  # rows covered by a gate block
    is_gs = np.zeros(n_virtual + 1, dtype=bool)
    is_gs[gate_starts] = True
    starts = np.sort(np.concatenate([gate_starts, np.nonzero(~inside)[0]]))
    sizes = np.where(is_gs[starts], 4, 1).astype(np.int64)
    n_blocks = len(starts)
    prefix = np.concatenate([[0], np.cumsum(sizes)])
    assert prefix[-1] == n_virtual, "gate blocks overlap"

    cols_blocks = np.zeros(n_blocks, dtype=np.int64)
    col_base = np.zeros(n_blocks, dtype=np.int64)
    j0, col = 0, 0
    while j0 < n_blocks:
        j1 = int(np.searchsorted(prefix, prefix[j0] + usable, side="right")) - 1
        assert j1 > j0, "column too short for a gate block"
        cols_blocks[j0:j1] = col
        col_base[j0:j1] = prefix[j0]
        col += 1
        j0 = j1
    col_of = np.repeat(cols_blocks, sizes)
    row_of = np.repeat(prefix[:n_blocks] - col_base, sizes) + (
        np.arange(n_virtual) - np.repeat(prefix[:n_blocks], sizes)
    )
    num_advice = col

    # ---- selector columns --------------------------------------------------
    q = np.zeros((num_advice, n), dtype=np.uint8)
    q[col_of[gate_starts], row_of[gate_starts]] = 1

    # ---- lookup advice columns --------------------------------------------
    n_lookups = len(table.lookups)
    num_lookup_advice = max(0, -(-n_lookups // usable))
    lookup_src = np.full((max(num_lookup_advice, 0), n), -1, dtype=np.int64)
    for j, vrow in enumerate(table.lookups):
        lc, lr = divmod(j, usable)
        lookup_src[lc, lr] = vrow

    # ---- fixed constant column --------------------------------------------
    # First-appearance dedup of constants into fixed-column cells.
    fixed_const = np.zeros(n, dtype=object)
    const_vals = np.asarray(table.const_val, dtype=object)
    const_idx = np.asarray(table.const_idx, dtype=np.int64)
    if len(const_vals):
        uniq_vals, first_idx, inv = np.unique(
            const_vals, return_index=True, return_inverse=True
        )
        appearance = np.argsort(first_idx, kind="stable")  # unique-id -> slot order
        slot_of_uniq = np.empty(len(uniq_vals), dtype=np.int64)
        slot_of_uniq[appearance] = np.arange(len(uniq_vals))
        assert len(uniq_vals) <= usable, "fixed column overflow"
        const_pos = slot_of_uniq[inv]
        fixed_const[slot_of_uniq] = uniq_vals
    else:
        const_pos = np.zeros(0, dtype=np.int64)

    # ---- permutation cycles ------------------------------------------------
    # Columns in the permutation: advice 0..na-1, lookup advice na..na+nl-1,
    # fixed at index na+nl, instance (public inputs) at na+nl+1 when present.
    # Equivalence classes via sparse connected components (the Python
    # union-find was O(n) interpreted); sigma walks each class in ascending
    # cell order — identical cycles to the previous discovery-order
    # construction, which also appended members sorted.
    publics = np.asarray(table.publics, dtype=np.int64)
    num_instance = 1 if len(publics) else 0
    assert len(publics) <= usable, "instance column overflow"
    n_perm_cols = num_advice + num_lookup_advice + 1 + num_instance
    total = n_perm_cols * n
    fixed_col = num_advice + num_lookup_advice
    inst_col = fixed_col + 1  # only meaningful when num_instance == 1

    vcells = col_of * n + row_of  # virtual row -> advice cell id

    copy_a = np.asarray(table.copy_a, dtype=np.int64)
    copy_b = np.asarray(table.copy_b, dtype=np.int64)
    lc_idx, lr_idx = np.nonzero(lookup_src >= 0)
    ea = np.concatenate([
        vcells[copy_a],
        vcells[const_idx] if len(const_idx) else np.zeros(0, np.int64),
        vcells[lookup_src[lc_idx, lr_idx]],
        vcells[publics],
    ])
    eb = np.concatenate([
        vcells[copy_b],
        fixed_col * n + const_pos if len(const_idx) else np.zeros(0, np.int64),
        (num_advice + lc_idx) * n + lr_idx,
        inst_col * n + np.arange(len(publics), dtype=np.int64),
    ])

    sigma = np.arange(total, dtype=np.int64)
    if len(ea):
        import scipy.sparse
        from scipy.sparse.csgraph import connected_components

        cells = np.unique(np.concatenate([ea, eb]))
        m = len(cells)
        ia = np.searchsorted(cells, ea)
        ib = np.searchsorted(cells, eb)
        graph = scipy.sparse.coo_matrix(
            (np.ones(len(ia), dtype=np.int8), (ia, ib)), shape=(m, m)
        )
        _, labels = connected_components(graph, directed=False)
        order = np.lexsort((cells, labels))
        sc = cells[order]
        sl = labels[order]
        is_start = np.r_[True, sl[1:] != sl[:-1]]
        grp_start = sc[np.maximum.accumulate(np.where(is_start, np.arange(m), 0))]
        nxt = np.r_[sc[1:], np.int64(-1)]
        is_last = np.r_[is_start[1:], True]
        nxt[is_last] = grp_start[is_last]
        sigma[sc] = nxt
    sigma_col = (sigma // n).reshape(n_perm_cols, n)
    sigma_row = (sigma % n).reshape(n_perm_cols, n)

    config = ConfigParams(k, lookup_bits, num_advice, num_lookup_advice)
    return CircuitLayout(
        config=config,
        n=n,
        col_of=col_of,
        row_of=row_of,
        q=q,
        fixed_const=fixed_const,
        sigma_col=sigma_col,
        sigma_row=sigma_row,
        lookup_src=lookup_src,
        n_virtual=n_virtual,
        publics=publics,
    )


def instance_column(table: VirtualTable, layout: CircuitLayout) -> np.ndarray:
    """(n,) object array: the instance column's values (public inputs in
    exposure order, zero elsewhere). Empty publics -> all-zero column."""
    out = np.zeros(layout.n, dtype=object)
    if len(layout.publics):
        vals = np.asarray(table.values, dtype=object)
        out[: len(layout.publics)] = vals[layout.publics]
    return out


def witness_columns(table: VirtualTable, layout: CircuitLayout, blinding_seed: bytes = b"") -> np.ndarray:
    """(num_advice, n) object array of advice values; blinding rows filled
    deterministically from the seed (zk blinding; deterministic for the
    reproducibility tests, random seed in production use)."""
    import hashlib

    from ..ff.host import FR_MOD

    adv = np.zeros((layout.num_advice, layout.n), dtype=object)
    adv[layout.col_of, layout.row_of] = table.values
    usable = layout.n - BLINDING_ROWS
    for c in range(layout.num_advice):
        for r in range(usable, layout.n):
            h = hashlib.blake2b(blinding_seed + b"blind" + bytes([c]) + r.to_bytes(4, "little")).digest()
            adv[c, r] = int.from_bytes(h, "little") % FR_MOD
    return adv


def lookup_columns(table: VirtualTable, layout: CircuitLayout) -> np.ndarray:
    """(num_lookup_advice, n) object array: tagged cell values, 0 for unused
    slots (0 is a member of the range table). Vectorized gather — the
    per-cell Python loop was O(nl * n) interpreted)."""
    out = np.zeros((max(layout.num_lookup_advice, 0), layout.n), dtype=object)
    if layout.num_lookup_advice:
        src = layout.lookup_src
        mask = src >= 0
        vals = np.asarray(table.values, dtype=object)
        out[mask] = vals[src[mask]]
    return out
