"""Small configurations for the benchmark's CPU tests, defined here and
never run on the card: K=10, ENC=16/LIMB=8 proofs and 2^10-point
commitments (`benches.bench_cpu_proxy`'s proxy size)."""
from __future__ import annotations

import pytest

SMALL = {
    "k14_enc": {"k": 10, "lookup_bits": 9, "enc_bits": 16, "limb_bits": 8},
    "k14_add": {"k": 10, "lookup_bits": 9, "enc_bits": 16, "limb_bits": 8},
    "msm_2e20_uniform": {"log2_points": 10},
}


@pytest.fixture
def run_cpu(capsys):
    """run_cpu(cell, seed, seconds, trace, patch) -> (rc, result or None)."""
    import json

    from benchmark import run

    def go(cell, seed=2147483900, seconds=0.5, trace=0, patch=None):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", patch=patch, config_override=SMALL[cell])
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if out else None)

    return go
