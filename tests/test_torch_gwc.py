"""The PyTorch port's GWC multi-open against the proof the JAX package made
with PAILLIER_TPU_MULTIOPEN=gwc: `tests/torch_fixtures/slice_enc_k10_gwc.json`
(written by `tests/torch_fixtures/make_slice_fixture.py gwc`), the K=10,
lookup_bits=9, ENC=16/LIMB=8 encryption circuit with SRS seed b"plonk-test"
and blinding seed b"test-blind". The port picks the scheme with
`keygen(..., multiopen="gwc")`. On the CPU it runs the kernels' plain
versions and commits through the native engine; the proof must be
byte-identical.
"""
import dataclasses
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

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"


@pytest.fixture(scope="module")
def fx():
    return json.loads((FIXTURES / "slice_enc_k10_gwc.json").read_text())


@pytest.fixture(scope="module")
def gwc_run(fx):
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"], **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    table = ctx.finalize()
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), "cpu")
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs, multiopen="gwc")
    proof = create_proof(pk, table, fx["blinding_seed"].encode())
    return table, pk, srs, proof


def _hex(p):
    return None if p is None else ["%x" % p[0], "%x" % p[1]]


def test_vk_matches_fixture_and_the_shplonk_key(fx, gwc_run):
    """The scheme changes no commitment: the GWC key's equal the fixture's
    and the SHPLONK fixture's, from the same circuit and SRS."""
    vk = gwc_run[1].vk
    assert vk.multiopen == fx["multiopen"] == "gwc"
    commits = {
        "q_commits": [_hex(p) for p in vk.q_commits],
        "fixed_const_commit": _hex(vk.fixed_const_commit),
        "table_commit": _hex(vk.table_commit),
        "sigma_commits": [_hex(p) for p in vk.sigma_commits],
    }
    assert commits == fx["vk"]
    assert commits == json.loads((FIXTURES / "slice_enc_k10.json").read_text())["vk"]


def test_proof_bytes_match_fixture(fx, gwc_run):
    proof = gwc_run[3]
    assert len(proof) == len(fx["proof_hex"]) // 2
    assert proof.hex() == fx["proof_hex"]


@pytest.mark.parametrize("tamper", ["none", "point", "scalar", "w_point", "truncated", "extended"])
def test_verifier_accepts_only_the_proof(gwc_run, tamper):
    _, pk, srs, proof = gwc_run
    bad = bytearray(proof)
    if tamper == "point":
        bad[40] ^= 1  # inside the second advice commitment
    elif tamper == "scalar":
        bad[-6 * 32 - 100] ^= 1  # inside the evaluations
    elif tamper == "w_point":
        bad[-20] ^= 1  # inside the last W commitment
    elif tamper == "truncated":
        bad = bad[:-32]
    elif tamper == "extended":
        bad += bytes(32)
    assert verify_proof(pk.vk, srs, bytes(bad)) is (tamper == "none")


def test_unknown_scheme_raises(gwc_run):
    table, pk, srs, proof = gwc_run
    with pytest.raises(ValueError, match="bogus"):
        keygen(table, pk.k, pk.vk.lookup_bits, srs, multiopen="bogus")
    bogus = dataclasses.replace(pk.vk, multiopen="bogus")
    with pytest.raises(ValueError, match="bogus"):
        verify_proof(bogus, srs, proof)
    with pytest.raises(ValueError, match="bogus"):
        create_proof(dataclasses.replace(pk, vk=bogus), table, b"test-blind")
