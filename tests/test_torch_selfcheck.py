"""The prover's and verifier's self-checks (`create_proof(..., checks=)`,
`verify_proof(..., selfcheck=)`), the counterparts of the JAX package's
`PAILLIER_TPU_SELFCHECK` checks (`paillier_halo2_tpu/plonk/prover.py:47-60,
393-396, 850-862, 996-1031`, `verifier.py:323-334`).

On the CPU's default NTT route (the native engine) and at every level, the
proof bytes equal the JAX package's fixtures
(`tests/torch_fixtures/slice_enc_k10.json` and `slice_enc_k10_gwc.json`:
K=10, lookup_bits=9, ENC=16/LIMB=8, SRS seed b"plonk-test", blinding seed
b"test-blind"). Each heavy check raises ValueError on a bad input, the
closing checks on an unsatisfied witness.
"""
import dataclasses
import json
import os
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import host
from paillier_halo2_tpu_torch.gadgets.context import Context
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
from paillier_halo2_tpu_torch.plonk import prover
from paillier_halo2_tpu_torch.plonk.keygen import keygen
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof
from paillier_halo2_tpu_torch.poly import ops

torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
NAMES = {"shplonk": "slice_enc_k10.json", "gwc": "slice_enc_k10_gwc.json"}
P = host.FR_MOD


@pytest.fixture(scope="module")
def setup():
    """The fixtures' table and SRS, and a key for each scheme."""
    fx = {mo: json.loads((FIXTURES / name).read_text()) for mo, name in NAMES.items()}
    base = fx["shplonk"]
    assert all(base[key] == fx["gwc"][key] for key in
               ("k", "lookup_bits", "enc_bits", "limb_bits", "inputs", "srs_seed", "blinding_seed"))
    inp = PaillierEncryptionInput(enc_bits=base["enc_bits"], limb_bits=base["limb_bits"],
                                  **base["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, base["lookup_bits"]), inp)
    table = ctx.finalize()
    srs = generate_srs(base["k"], base["srs_seed"].encode(), "cpu")
    pk = keygen(table, base["k"], base["lookup_bits"], srs)
    # the schemes' keys differ in `vk.multiopen` alone (`tests/test_torch_gwc.py`
    # holds a GWC key's commitments equal to the SHPLONK fixture's)
    pks = {"shplonk": pk, "gwc": dataclasses.replace(pk, vk=dataclasses.replace(pk.vk,
                                                                                 multiopen="gwc"))}
    return fx, table, srs, pks


@pytest.mark.parametrize("checks", ["all", "none"])
@pytest.mark.parametrize("multiopen", ["shplonk", "gwc"])
def test_checked_proof_equals_fixture(setup, capsys, multiopen, checks):
    fx, table, _, pks = setup
    ops.reset_ntt_routes()
    proof = prover.create_proof(pks[multiopen], table, fx[multiopen]["blinding_seed"].encode(),
                                checks=checks)
    assert proof.hex() == fx[multiopen]["proof_hex"]
    # the CPU's default route: every transform on the native engine
    assert ops.NTT_ROUTES["native"] > 0 and ops.NTT_ROUTES["torch"] == ops.NTT_ROUTES["mesh"] == 0
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[selfcheck]")]
    if checks == "none":
        assert lines == []
    else:
        assert lines[0] == "[selfcheck] t degree tail: 0/1024 nonzero coeffs past 3n (ok)"
        if multiopen == "shplonk":
            assert lines[1:] == ["[selfcheck] shplonk L(u) == 0: True"]
        else:
            assert len(lines) == 7 and all(x.endswith("fold==f(z): True; division identity: True")
                                           for x in lines[1:])


def test_degree_tail_check():
    n = 16
    t = torch.zeros((8, 4 * n), dtype=torch.int32)
    t[:, : 3 * n] = f.pack_ints(list(range(1, 3 * n + 1)), "cpu")
    prover._check_degree_tail(t, 3, n)
    t[2, 3 * n + 5] = 1  # one nonzero coefficient past 3n
    with pytest.raises(ValueError, match="degree overflow: 1 nonzero"):
        prover._check_degree_tail(t, 3, n)


def _mont(vals):
    return f.pack_ints([v % P * f.FR.r_mod_p % P for v in vals], "cpu")


def test_shplonk_l_check():
    u = random.Random(1).randrange(P)
    prover._check_shplonk_l(_mont([P - u, 1, 0, 0]), u)  # L(X) = X - u
    with pytest.raises(ValueError, match="L\\(u\\) != 0"):
        prover._check_shplonk_l(_mont([P - u + 1, 1, 0, 0]), u)


def test_gwc_set_check():
    prng = random.Random(2)
    n = 32
    coeffs = [prng.randrange(P) for _ in range(n)]
    z, nu = prng.randrange(P), prng.randrange(P)
    e1 = prng.randrange(P)  # the fold of two evaluations: e1 * nu + e2 == f(z)
    e2 = (sum(c * pow(z, i, P) for i, c in enumerate(coeffs)) - e1 * nu) % P
    ev = prover._Evaluator(n, "cpu")
    prover._check_gwc_set(ev, "x", _mont(coeffs), z, [e1, e2], nu)
    with pytest.raises(ValueError, match="GWC self-check failed at wx"):
        prover._check_gwc_set(ev, "wx", _mont(coeffs), z, [e1, (e2 + 1) % P], nu)


def test_unknown_check_level_raises(setup):
    _, table, _, pks = setup
    with pytest.raises(ValueError, match="unknown self-check level"):
        prover.create_proof(pks["shplonk"], table, b"x", checks="heavy")


def test_unsatisfied_witness(capsys):
    """A broken copy constraint in a small circuit (products of witnesses,
    range-checked, at k=6): the closing check raises before any proof;
    without checks the proof is made and the verifier rejects it at the
    quotient identity."""
    ctx = Context()
    rc = RangeChip(ctx, 4)
    prod = rc.gate.mul(ctx.load_witness([3, 5, 7, 11]), ctx.load_witness([2, 4, 6, 8]))
    rc.range_check(prod, 8)
    table = ctx.finalize()
    srs = generate_srs(6, b"selfcheck", "cpu")
    pk = keygen(table, 6, 4, srs)
    assert verify_proof(pk.vk, srs, prover.create_proof(pk, table, b"witness"))
    values = np.array(table.values, dtype=object, copy=True)
    b = int(table.copy_b[0])
    values[b] = (int(values[b]) + 1) % (1 << 4)
    bad = dataclasses.replace(table, values=values)
    with pytest.raises(ValueError, match="permutation product does not close"):
        prover.create_proof(pk, bad, b"bad-witness")
    proof = prover.create_proof(pk, bad, b"bad-witness", checks="none")
    capsys.readouterr()
    assert verify_proof(pk.vk, srs, proof) is False
    assert "[verifier] quotient identity FAILED at x" in capsys.readouterr().out


def test_verifier_selfcheck_on_gwc_fixture(setup, capsys):
    fx, _, srs, pks = setup
    proof = bytes.fromhex(fx["gwc"]["proof_hex"])
    vk = pks["gwc"].vk
    assert verify_proof(vk, srs, proof, selfcheck=True) is True
    lines = capsys.readouterr().out.splitlines()
    keys = ["x", "wx", "w2x", "w3x"] + ["winvx"] * (vk.num_lookup_advice > 0) \
        + ["wux"] * (len(vk.perm_chunks) > 1)
    assert lines == [f"[verifier selfcheck] opening@{key}: ok" for key in keys]
    # the last two W points swapped: both on the curve, the quotient
    # identity untouched, both of their openings wrong
    bad = proof[:-64] + proof[-32:] + proof[-64:-32]
    assert verify_proof(vk, srs, bad, selfcheck=True) is False
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"[verifier selfcheck] opening@{key}: {'ok' if i < len(keys) - 2 else '** FAILS **'}"
                     for i, key in enumerate(keys)] + [
        "[verifier] gwc pairing check FAILED (quotient identity held)"]
