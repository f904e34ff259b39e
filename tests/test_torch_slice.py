"""The PyTorch port's whole slice — SRS, keygen, proof, verify — against the
proof the JAX package produced: `tests/torch_fixtures/slice_enc_k10.json`
(written by `tests/torch_fixtures/make_slice_fixture.py`), the K=10,
lookup_bits=9, ENC=16/LIMB=8 encryption circuit with SRS seed b"plonk-test"
and blinding seed b"test-blind", SHPLONK.

The port runs on the CPU here: the plain versions of its kernels, and the
native engine for the commitments, as the JAX package commits on the CPU.
The proof's transforms take the port's torch NTT (`ops.ntt_backend("torch")`),
the arithmetic the card runs, not the CPU's default native NTT, so that one
whole proof keeps that NTT covered here.
The proof must be byte-identical and the verifying-key commitments equal. A
commitment is a point, so the engine changes no byte (`chip_smoke.py` proves
the same bytes on the card, commitments on the signed MSM route).
"""
import json
from pathlib import Path

import pytest

from paillier_halo2_tpu_torch.gadgets.context import Context
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
from paillier_halo2_tpu_torch.plonk.keygen import keygen
from paillier_halo2_tpu_torch.plonk.prover import create_proof
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof
from paillier_halo2_tpu_torch.poly import ops

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "slice_enc_k10.json"


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def slice_run(fx):
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"], **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    table = ctx.finalize()
    assert table.n_rows == fx["n_rows"]
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), "cpu")
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs)
    ops.reset_ntt_routes()
    with ops.ntt_backend("torch"):
        proof = create_proof(pk, table, fx["blinding_seed"].encode())
    assert ops.NTT_ROUTES["torch"] > 0 and ops.NTT_ROUTES["native"] == 0
    return pk, srs, proof


def _hex(p):
    return None if p is None else ["%x" % p[0], "%x" % p[1]]


def test_vk_commitments_match_fixture(fx, slice_run):
    vk = slice_run[0].vk
    assert (vk.num_advice, vk.num_lookup_advice, vk.multiopen) == (
        fx["num_advice"], fx["num_lookup_advice"], fx["multiopen"],
    )
    assert {
        "q_commits": [_hex(p) for p in vk.q_commits],
        "fixed_const_commit": _hex(vk.fixed_const_commit),
        "table_commit": _hex(vk.table_commit),
        "sigma_commits": [_hex(p) for p in vk.sigma_commits],
    } == fx["vk"]


def test_proof_bytes_match_fixture(fx, slice_run):
    proof = slice_run[2]
    assert len(proof) == len(fx["proof_hex"]) // 2
    assert proof.hex() == fx["proof_hex"]


@pytest.mark.parametrize("tamper", ["none", "point", "scalar", "truncated", "extended"])
def test_verifier_accepts_only_the_proof(slice_run, tamper):
    pk, srs, proof = slice_run
    bad = bytearray(proof)
    if tamper == "point":
        bad[40] ^= 1  # inside the second advice commitment
    elif tamper == "scalar":
        bad[-100] ^= 1  # inside the evaluations
    elif tamper == "truncated":
        bad = bad[:-32]
    elif tamper == "extended":
        bad += bytes(32)
    assert verify_proof(pk.vk, srs, bytes(bad)) is (tamper == "none")
