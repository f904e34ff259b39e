"""The PyTorch port's distributed prover (`plonk/distributed.py`) and its
dry run (`entry.dryrun_multichip`) on a CPU mesh.

The circuit is the JAX package's distributed-test circuit
(`tests/test_distributed.py::_add_table(seed=2024)`: two Paillier additions,
2 advice columns, K=10, lookup_bits=9); its single-device JAX proof with the
seed-b"" SRS and blinding seed b"dist-test" is the fixture
`tests/torch_fixtures/dist_add_k10.json` (`make_slice_fixture.py dist`).
`keygen_sharded` and `create_proof_sharded` over `make_mesh(4, "cpu")` run
every transform as the four-step NTT and every commitment as the sharded MSM
(each shard on the unsigned route's plain kernels): the verifying key and
the proof bytes must equal the fixture's, as the port's single-device key
and proof (commitments through the native engine) do.
"""
import json
from pathlib import Path

import pytest

from paillier_halo2_tpu_torch.bignum.host import paillier_add_native
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.entry import dryrun_multichip
from paillier_halo2_tpu_torch.gadgets.context import Context
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness.circuits import PaillierAddCipherInput, paillier_enc_add_test
from paillier_halo2_tpu_torch.mesh import msm as mesh_msm
from paillier_halo2_tpu_torch.mesh.sharding import make_mesh
from paillier_halo2_tpu_torch.plonk import kzg
from paillier_halo2_tpu_torch.plonk.distributed import create_proof_sharded, keygen_sharded
from paillier_halo2_tpu_torch.plonk.keygen import keygen
from paillier_halo2_tpu_torch.plonk.prover import create_proof
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof
from paillier_halo2_tpu_torch.poly import ops

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "dist_add_k10.json"


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


def _vk_hex(vk):
    h = lambda p: None if p is None else ["%x" % p[0], "%x" % p[1]]  # noqa: E731
    return {"q_commits": [h(p) for p in vk.q_commits],
            "fixed_const_commit": h(vk.fixed_const_commit), "table_commit": h(vk.table_commit),
            "sigma_commits": [h(p) for p in vk.sigma_commits]}


@pytest.fixture(scope="module")
def runs(fx):
    """The single-device and the 4-shard key and proof, with the number of
    sharded MSM calls the latter made (counted as
    `tests/test_distributed.py:96-111` counts them)."""
    ctx = Context()
    rc = RangeChip(ctx, fx["lookup_bits"])
    for x in fx["inputs"]:
        paillier_enc_add_test(ctx, rc, PaillierAddCipherInput(
            limb_bits=fx["limb_bits"], enc_bits=fx["enc_bits"], n=x["n"], g=x["g"],
            c1=x["c1"], c2=x["c2"], res=paillier_add_native(x["n"], x["c1"], x["c2"])))
    table = ctx.finalize()
    assert table.n_rows == fx["n_rows"]
    k, lk, blind = fx["k"], fx["lookup_bits"], fx["blinding_seed"].encode()
    srs = generate_srs(k, fx["srs_seed"].encode(), "cpu")
    pk = keygen(table, k, lk, srs)
    proof = create_proof(pk, table, blind)

    calls = {"n": 0}
    orig = mesh_msm.msm_sharded_multi

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    mesh = make_mesh(4, "cpu")
    mesh_msm.msm_sharded_multi = counted
    try:
        pk_s = keygen_sharded(mesh, table, k, lk, srs)
        proof_s = create_proof_sharded(mesh, pk_s, table, blind)
    finally:
        mesh_msm.msm_sharded_multi = orig
    return {"table": table, "srs": srs, "pk": pk, "proof": proof, "pk_s": pk_s,
            "proof_s": proof_s, "calls": calls["n"]}


def test_single_device_proof_matches_fixture(fx, runs):
    assert _vk_hex(runs["pk"].vk) == fx["vk"]
    assert runs["proof"].hex() == fx["proof_hex"]


def test_sharded_keygen_matches_fixture(fx, runs):
    vk_s = runs["pk_s"].vk
    assert (vk_s.num_advice, vk_s.num_lookup_advice) == (fx["num_advice"], fx["num_lookup_advice"])
    assert _vk_hex(vk_s) == fx["vk"]
    assert vk_s.fixed_commitments() == runs["pk"].vk.fixed_commitments()


def test_sharded_proof_is_byte_identical(fx, runs):
    assert runs["proof_s"].hex() == fx["proof_hex"]


def test_sharded_prover_ran_the_sharded_msm(runs):
    assert runs["calls"] >= 5, f"sharded MSM called {runs['calls']} times"


def test_sharded_proof_verifies(runs):
    assert verify_proof(runs["pk_s"].vk, runs["srs"], runs["proof_s"])
    bad = bytearray(runs["proof_s"])
    bad[40] ^= 1
    assert not verify_proof(runs["pk_s"].vk, runs["srs"], bytes(bad))


def test_single_device_key_proves_over_a_mesh_of_8(fx, runs):
    """Over all eight shards, as `tests/test_distributed.py` proves over its
    eight CPU devices: the key made on one device gives the fixture's bytes."""
    proof = create_proof_sharded(make_mesh(8, "cpu"), runs["pk"], runs["table"],
                                 fx["blinding_seed"].encode())
    assert proof.hex() == fx["proof_hex"]

def test_commit_many_shards_only_widths_the_mesh_divides(runs, monkeypatch):
    """Under a mesh of 4 a commitment of width 8 takes the sharded MSM, one
    of width 6 the native engine, and both equal the host's MSM."""
    srs = runs["srs"]
    calls = []
    orig = mesh_msm.msm_sharded_multi
    monkeypatch.setattr(mesh_msm, "msm_sharded_multi",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    bases = srs.g1_points(8)
    for m, sharded in ((8, 1), (6, 0)):
        vals = [3 * i + 1 for i in range(m)]
        coeffs = ops.to_device_mont(vals, "cpu")
        with ops.proving_mesh(make_mesh(4, "cpu")):
            got = kzg.commit(srs, coeffs)
        assert got == ech.g1_msm(bases[:m], vals)
        assert len(calls) == sharded
        calls.clear()


def test_mesh_routes_only_sizes_the_four_step_splits():
    mesh = make_mesh(4, "cpu")
    assert ops._mesh_for(64) is None
    with ops.proving_mesh(mesh):
        assert ops._mesh_for(64) is mesh and ops._mesh_for(8) is None
        with ops.proving_mesh(make_mesh(1, "cpu")):
            assert ops._mesh_for(64) is None
        assert ops.active_mesh() is mesh
    assert ops.active_mesh() is None


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    dryrun_multichip(2, device="cpu")
    assert "dry run complete" in capsys.readouterr().err
