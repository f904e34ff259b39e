"""The control and the faults of the timed path read as not correct: the
check can fail. Small configurations on the CPU; the control at the cells'
own size runs on the card (`python3 -m benchmark.control`)."""
from __future__ import annotations

import pytest

from benchmark.control import control_readings

from .conftest import SMALL


@pytest.mark.parametrize("cell,steps", [("k14_enc", 1), ("k14_add", 1), ("msm_2e20_uniform", 4)])
def test_control_is_not_correct(cell, steps):
    found = control_readings(cell, 2147483901, steps, "cpu", config_override=SMALL[cell])
    assert any(v > 0 for v in found.values()), found


def _stale_proof(system):
    stale = system.run(-2, system.draw(-2), system_phases())["proof"]
    orig = system.run
    system.run = lambda i, st, phases: {**orig(i, st, phases), "proof": stale}


def _altered_proof(system):
    orig = system.run

    def run(i, st, phases):
        rec = orig(i, st, phases)
        p = bytearray(rec["proof"])
        p[-40] ^= 1  # inside the last evaluation
        return {**rec, "proof": bytes(p)}
    system.run = run


def _stale_point(system):
    _, stale = system.run(0, system.draw(0), system_phases())
    orig = system.run
    system.run = lambda i, c, phases: (orig(i, c, phases)[0], stale)


def _cached_point(system):
    """A commitment cached by the storage of its coefficients: right for
    the first vector drawn into a block of memory, stale for each later
    one."""
    orig, cache = system.run, {}

    def run(i, c, phases):
        key = c.data_ptr()
        if key not in cache:
            cache[key] = orig(i, c, phases)[1]
        return i, cache[key]
    system.run = run


def _altered_point(system):
    from benchmark.reference import bn254

    orig = system.run
    system.run = lambda i, c, phases: (lambda j, pt: (j, bn254.neg(pt)))(*orig(i, c, phases))


def _half_batch(system):
    orig = system.run

    def run(i, c, phases):
        c = c.clone()
        c[:, c.shape[1] // 2:] = 0
        return orig(i, c, phases)
    system.run = run


def system_phases():
    from benchmark.trace import HostPhases

    return HostPhases()


@pytest.mark.parametrize("cell,fault", [
    ("k14_add", _stale_proof), ("k14_add", _altered_proof),
    ("k14_enc", _stale_proof),
    ("msm_2e20_uniform", _stale_point), ("msm_2e20_uniform", _cached_point),
    ("msm_2e20_uniform", _altered_point), ("msm_2e20_uniform", _half_batch),
])
def test_fault_is_not_correct(run_cpu, cell, fault):
    rc, res = run_cpu(cell, patch=fault)
    assert rc == 0 and res["correct"] is False, res["checks"]
