"""The batch prover's cell (`k17_batch16_enc`) on the CPU at a small size:
a sound run reads correct, and planted faults and the control read not
correct. The cell's own size runs on the card (`python3 -m benchmark.run`,
`python3 -m benchmark.control`)."""
from __future__ import annotations

import json
import os

import pytest

from benchmark import run
from benchmark.control import control_readings

CELL = "k17_batch16_enc"
SMALL = {"k": 10, "enc_bits": 8, "limb_bits": 4, "batch": 2, "lookup_bits": 9}


def run_small(capsys, patch=None, seed=2147483904):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"],
                  device="cpu", patch=patch, config_override=SMALL)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    rc, res = run_small(capsys)
    assert rc == 0 and res["correct"] is True and res["failed"] == 0, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["metrics"]["proof_s"]["value"] > 0 and res["metrics"]["setup_s"]["value"] > 0


def _raised_limb(instance):
    def patch(system):
        orig = system.run

        def step(i, sts, phases):
            rec = orig(i, sts, phases)
            low = rec["cipher_idx"][instance][0]
            rec["table"].values[low] = int(rec["table"].values[low]) + 1
            return rec
        system.run = step
    return patch


def _swapped_statements(system):
    orig = system.run

    def step(i, sts, phases):
        rec = orig(i, sts, phases)
        return {**rec, "statements": [rec["statements"][1], rec["statements"][0],
                                      *rec["statements"][2:]]}
    system.run = step


@pytest.mark.parametrize("fault,wrong", [(_raised_limb(1), 1), (_swapped_statements, 2)],
                         ids=["raised-limb", "swapped-statements"])
def test_fault_is_not_correct(capsys, fault, wrong):
    rc, res = run_small(capsys, patch=fault)
    assert rc == 0 and res["correct"] is False
    steps = res["attempted"]
    assert res["checks"]["ciphertexts_wrong"]["value"] == wrong * steps, res["checks"]


def test_control_is_not_correct():
    found = control_readings(CELL, 2147483905, 1, "cpu", config_override=SMALL)
    assert found["ciphertexts_wrong"] >= 1 and found["proofs_rejected"] >= 1, found


def test_traffic_holds_only_what_the_batch_prover_reads():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "traffic", "batch16_enc_closed.json")) as fh:
        traffic = json.load(fh)
    assert set(traffic) == {"statement", "keygen", "per_run", "per_step", "profiled_steps", "why"}
