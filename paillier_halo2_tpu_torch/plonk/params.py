"""Leaf config module — shared by the plonk core and the test harness.

Holds the blinding-row count and the auto-sized column configuration
(analog of the `config_params` the reference harness prints,
upstream src/bench.rs:173). Lives under plonk/ (not harness/) so the
proving system never imports the harness package (a cycle
plonk.keygen -> harness.base_test -> harness.bench -> plonk.keygen).

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/plonk/params.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import dataclasses

# Rows reserved at the bottom of each column for blinding factors (halo2
# convention; exact count fixed by the proving system's degree bound).
BLINDING_ROWS = 10


@dataclasses.dataclass
class ConfigParams:
    """Auto-sized column configuration — analog of the `config_params` the
    reference harness prints (upstream src/bench.rs:173)."""

    k: int
    lookup_bits: int
    num_advice: int
    num_lookup_advice: int
    num_fixed: int = 1

    @classmethod
    def size_for(cls, table, k: int, lookup_bits: int) -> "ConfigParams":
        usable = (1 << k) - BLINDING_ROWS
        num_advice = max(1, -(-table.n_rows // usable))
        num_lookup_advice = max(1, -(-len(table.lookups) // usable)) if len(table.lookups) else 0
        return cls(k, lookup_bits, num_advice, num_lookup_advice)
