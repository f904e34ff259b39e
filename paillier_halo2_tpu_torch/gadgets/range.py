"""Range-check layer — re-design of halo2-base's `RangeChip` + lookup table
(SURVEY.md section 2.2). Values are decomposed into `lookup_bits`-bit chunks,
each chunk cell is tagged for membership in the [0, 2^lookup_bits) table, and
the recombination is constrained with a mul-add chain. Exact non-multiple bit
widths use the standard shift trick: additionally look up
chunk_top * 2^(lookup_bits - rem).

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/gadgets/range.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import numpy as np

from .context import Cells, Context
from .gate import GateChip


class RangeChip:
    def __init__(self, ctx: Context, lookup_bits: int) -> None:
        self.ctx = ctx
        self.gate = GateChip(ctx)
        self.lookup_bits = lookup_bits

    def range_check(self, x: Cells, bits: int) -> None:
        """Constrain every value in x to [0, 2^bits). Vectorized over x."""
        assert bits >= 1
        L = self.lookup_bits
        m = len(x)
        k = -(-bits // L)
        rem = bits - (k - 1) * L  # bits of the most significant chunk, in [1, L]

        # Decompose into (m, k) little-endian chunks and load them (one block).
        mask = (1 << L) - 1
        chunk_vals = np.empty((m, k), dtype=object)
        for i, v in enumerate(x.val):
            v = int(v)
            for j in range(k):
                chunk_vals[i, j] = v & mask
                v >>= L
            assert v == 0, "range_check witness out of range at synthesis time"
        chunks = self.ctx.load_witness(chunk_vals.reshape(-1))  # row-major (i, j)
        self.ctx.add_lookups(chunks.idx)

        # Column j of the chunk matrix lives at flat positions i*k + j.
        def col(j: int) -> Cells:
            sel = np.arange(m) * k + j
            return Cells(chunks.idx[sel], chunks.val[sel])

        # Recombine MSB-first: acc <- acc * 2^L + chunk_j.
        acc = col(k - 1)
        for j in range(k - 2, -1, -1):
            acc = self.gate.mul_add(acc, self.ctx.load_constants([1 << L]), col(j))
        self.gate.assert_equal(acc, x)

        # Exact top-chunk width.
        if rem < L:
            shifted = self.gate.mul(col(k - 1), self.ctx.load_constants([1 << (L - rem)]))
            self.ctx.add_lookups(shifted.idx)
