"""Instance (public-input) columns in the PyTorch port, against the proof the
JAX package made for `tests/test_instance.py`'s statement:
`tests/torch_fixtures/instance_enc_k10.json` (written by
`tests/torch_fixtures/make_slice_fixture.py instance`). ENC=16/LIMB=8, K=10,
lookup_bits=9, inputs from `random.Random(23)`, n, g and the ciphertext
limbs exposed as public inputs, the seed-b"" SRS, blinding seed
b"\\x21" * 32, SHPLONK. The proof must be byte-identical, verify only with
the true public values, and the verifier must refuse a call without them.
"""
import json
from pathlib import Path

import pytest

from paillier_halo2_tpu_torch.bignum.host import paillier_enc_native
from paillier_halo2_tpu_torch.gadgets import (
    BigUintChip,
    Context,
    EncryptionPublicKeyAssigned,
    PaillierChip,
)
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.plonk.keygen import keygen
from paillier_halo2_tpu_torch.plonk.prover import create_proof
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "instance_enc_k10.json"


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


def public_table(fx):
    """The statement: encryption checked in-circuit, then n, g and the
    ciphertext limbs exposed in that order."""
    enc, limb = fx["enc_bits"], fx["limb_bits"]
    x = fx["inputs"]
    assert x["res"] == paillier_enc_native(x["n"], x["g"], x["m"], x["r"])
    ctx = Context()
    bu = BigUintChip(RangeChip(ctx, fx["lookup_bits"]), limb)
    pc = PaillierChip.construct(bu, enc)
    n_a, g_a = bu.assign_integer(x["n"], enc), bu.assign_integer(x["g"], enc)
    c = pc.encrypt(EncryptionPublicKeyAssigned(n_a, g_a), bu.assign_integer(x["m"], enc),
                   bu.assign_integer(x["r"], enc))
    res_a = bu.assign_integer(x["res"], enc * 2)
    bu.assert_equal_fresh(c, res_a)
    for cells in (n_a.limbs, g_a.limbs, res_a.limbs):
        ctx.expose_public(cells)
    return ctx.finalize()


@pytest.fixture(scope="module")
def public_setup(fx):
    table = public_table(fx)
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), "cpu")
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs)
    proof = create_proof(pk, table, fx["blinding_seed"].encode())
    return table, pk, srs, proof


def test_statement_matches_fixture(fx, public_setup):
    table, pk, _, _ = public_setup
    assert table.n_rows == fx["n_rows"]
    assert table.public_values() == fx["publics"]
    assert (pk.vk.num_instance, pk.vk.num_advice, pk.vk.num_lookup_advice) == (
        fx["num_instance"], fx["num_advice"], fx["num_lookup_advice"])
    assert [["%x" % c for c in p] for p in pk.vk.sigma_commits] == fx["vk"]["sigma_commits"]


def test_proof_bytes_match_fixture(fx, public_setup):
    proof = public_setup[3]
    assert len(proof) == len(fx["proof_hex"]) // 2
    assert proof.hex() == fx["proof_hex"]


def test_proof_verifies_with_true_publics(fx, public_setup):
    _, pk, srs, proof = public_setup
    assert verify_proof(pk.vk, srs, proof, instances=fx["publics"])


@pytest.mark.parametrize("change", ["ciphertext_limb", "modulus_limb", "one_fewer"])
def test_altered_publics_rejected(fx, public_setup, change):
    _, pk, srs, proof = public_setup
    bad = list(fx["publics"])
    if change == "ciphertext_limb":
        bad[-1] = (bad[-1] + 1) % (1 << fx["limb_bits"])  # claim another ciphertext
    elif change == "modulus_limb":
        bad[0] = (bad[0] + 1) % (1 << fx["limb_bits"])
    else:
        bad = bad[:-1]
    assert not verify_proof(pk.vk, srs, proof, instances=bad)


def test_missing_instances_raise(public_setup):
    _, pk, srs, proof = public_setup
    with pytest.raises(ValueError, match="instances="):
        verify_proof(pk.vk, srs, proof)
