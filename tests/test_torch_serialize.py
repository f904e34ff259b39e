"""Proving-key save and load in the PyTorch port (`plonk/serialize.py`), in
the JAX package's `.npz` format: a key the port saves loads back into the
port and into the JAX package's `load_proving_key`; a key the JAX package's
`save_proving_key` writes loads into the port; a proof from each loaded key
equals `tests/torch_fixtures/slice_enc_k10.json` byte for byte. The JAX side
here only reads and writes numpy arrays (`jnp.asarray`): no keygen, no
graph. Also: the port's `v2` fingerprint, and the load errors.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import host
from paillier_halo2_tpu_torch.gadgets.context import Context
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
from paillier_halo2_tpu_torch.plonk.keygen import DELTA, keygen
from paillier_halo2_tpu_torch.plonk.prover import create_proof
from paillier_halo2_tpu_torch.plonk.serialize import (
    load_proving_key,
    save_proving_key,
    table_fingerprint,
)
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof
from paillier_halo2_tpu_torch.poly import ops

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "slice_enc_k10.json"
P = ops.P


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def key(fx, tmp_path_factory):
    """(table, srs, pk, path of the port's save, its fingerprint)."""
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"], **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    table = ctx.finalize()
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), "cpu")
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs)
    fp = table_fingerprint(table, fx["k"], fx["lookup_bits"])
    path = str(tmp_path_factory.mktemp("pk") / "pk.npz")
    save_proving_key(pk, path, table_fp=fp)
    return table, srs, pk, path, fp


def _hex(p):
    return None if p is None else ["%x" % p[0], "%x" % p[1]]


def _tensors(pk) -> dict:
    return {"q": torch.stack(pk.q_coeffs), "sigma": torch.stack(pk.sigma_coeffs),
            **{name: getattr(pk, name + "_coeffs")
               for name in ("fixed_const", "table", "active", "l0", "lu")}}


def test_port_save_load_gives_the_fixture(fx, key):
    table, srs, pk, path, fp = key
    pk2 = load_proving_key(path, srs, expect_table_fp=fp, device="cpu")
    vk = pk2.vk
    assert {
        "q_commits": [_hex(p) for p in vk.q_commits],
        "fixed_const_commit": _hex(vk.fixed_const_commit),
        "table_commit": _hex(vk.table_commit),
        "sigma_commits": [_hex(p) for p in vk.sigma_commits],
    } == fx["vk"]
    assert dataclasses.asdict(vk) == dataclasses.asdict(pk.vk)
    for name, t in _tensors(pk).items():
        assert torch.equal(_tensors(pk2)[name], t), name
    for name in ("col_of", "row_of", "q", "sigma_col", "sigma_row", "lookup_src", "publics"):
        assert np.array_equal(getattr(pk2.layout, name), getattr(pk.layout, name)), name
    assert list(pk2.table_values) == list(pk.table_values)
    assert list(pk2.layout.fixed_const) == list(pk.layout.fixed_const)
    proof = create_proof(pk2, table, fx["blinding_seed"].encode())
    assert proof.hex() == fx["proof_hex"]


def test_gwc_key_round_trip_proves_the_gwc_fixture(key, tmp_path):
    """A GWC key through save and load (`tests/test_serialize.py` takes a key
    of the JAX package the same way): the scheme survives in the key's meta,
    and the loaded key proves the GWC fixture's bytes, which the saved
    key's vk verifies."""
    table, srs, pk, _, _ = key
    fx = json.loads((FIXTURE.parent / "slice_enc_k10_gwc.json").read_text())
    # the schemes' keys differ in `vk.multiopen` alone (`tests/test_torch_gwc.py`)
    gwc = dataclasses.replace(pk, vk=dataclasses.replace(pk.vk, multiopen="gwc"))
    fp = table_fingerprint(table, fx["k"], fx["lookup_bits"], "gwc")
    path = str(tmp_path / "pk_gwc.npz")
    save_proving_key(gwc, path, table_fp=fp)
    loaded = load_proving_key(path, srs, expect_table_fp=fp, device="cpu")
    assert dataclasses.asdict(loaded.vk) == dataclasses.asdict(gwc.vk)
    proof = create_proof(loaded, table, fx["blinding_seed"].encode())
    assert proof.hex() == fx["proof_hex"]
    assert verify_proof(gwc.vk, srs, proof)


def _jax_srs(srs):
    from paillier_halo2_tpu.plonk.srs import SRS as JaxSRS

    return JaxSRS(srs.k, f.to_ref_digits(srs.g1_px), f.to_ref_digits(srs.g1_py),
                  srs.g1_inf.numpy(), srs.g2_gen, srs.g2_tau)


def test_port_key_loads_in_the_jax_package(key):
    from paillier_halo2_tpu.plonk import serialize as jser

    _, srs, pk, path, _ = key
    jpk = jser.load_proving_key(path, _jax_srs(srs))
    assert jpk.vk.fixed_commitments() == pk.vk.fixed_commitments()
    assert (jpk.vk.multiopen, jpk.vk.num_instance, jpk.vk.perm_chunks) == (
        pk.vk.multiopen, pk.vk.num_instance, pk.vk.perm_chunks)
    jt = {"q": np.stack([np.asarray(c) for c in jpk.q_coeffs], axis=1),
          "sigma": np.stack([np.asarray(c) for c in jpk.sigma_coeffs], axis=1),
          **{name: np.asarray(getattr(jpk, name + "_coeffs"))
             for name in ("fixed_const", "table", "active", "l0", "lu")}}
    for name, t in _tensors(pk).items():
        want = t.permute(1, 0, 2) if name in ("q", "sigma") else t
        assert torch.equal(f.from_ref_digits(jt[name], "cpu"), want), name
    # the stored permutation values are the ones whose iNTT is sigma_coeffs
    k = pk.k
    assert torch.equal(ops.coeffs_of(ops.to_device_mont(jpk.sigma_values, "cpu"), k),
                       torch.stack(pk.sigma_coeffs, dim=1))
    w = host.root_of_unity(k)
    for j, r in ((0, 0), (1, 5), (pk.vk.n_perm_cols - 1, pk.vk.n - 1)):
        assert jpk.id_values[j, r] == pow(DELTA, j, P) * pow(w, r, P) % P
    assert list(jpk.table_values) == list(pk.table_values)


def test_jax_saved_key_loads_in_the_port(fx, key, tmp_path):
    """The JAX package writes the loaded key again under its own `v1`
    fingerprint: the port refuses it where it expects its `v2` one, loads
    it without, and proves the fixture's bytes with it."""
    from paillier_halo2_tpu.plonk import serialize as jser

    table, srs, _, path, fp = key
    jpk = jser.load_proving_key(path, _jax_srs(srs))
    path2 = str(tmp_path / "pk_jax.npz")
    v1 = jser.table_fingerprint(table, fx["k"], fx["lookup_bits"])
    jser.save_proving_key(jpk, path2, table_fp=v1)
    with pytest.raises(ValueError, match="fingerprint"):
        load_proving_key(path2, srs, expect_table_fp=fp, device="cpu")
    pk3 = load_proving_key(path2, srs, device="cpu")
    proof = create_proof(pk3, table, fx["blinding_seed"].encode())
    assert proof.hex() == fx["proof_hex"]


def test_fingerprint_covers_scheme_and_array_shapes(fx, key):
    table = key[0]
    k, lk = fx["k"], fx["lookup_bits"]
    assert table_fingerprint(table, k, lk, "gwc") != table_fingerprint(table, k, lk, "shplonk")
    # move the last gate to the front of copy_a: the arrays' concatenated
    # bytes stay the same, their shapes do not
    moved = dataclasses.replace(table, gates=table.gates[:-1],
                                copy_a=np.concatenate([table.gates[-1:], table.copy_a]))
    assert table_fingerprint(moved, k, lk) != table_fingerprint(table, k, lk)
    from paillier_halo2_tpu.plonk import serialize as jser

    # the JAX package's v1 fingerprint, which the port does not copy, collides
    assert jser.table_fingerprint(moved, k, lk) == jser.table_fingerprint(table, k, lk)
    with pytest.raises(ValueError, match="bogus"):
        table_fingerprint(table, k, lk, "bogus")


def test_load_errors(key, tmp_path):
    _, srs, _, path, fp = key
    with pytest.raises(ValueError, match="fingerprint"):
        load_proving_key(path, srs, expect_table_fp="0" * 32, device="cpu")
    with pytest.raises(ValueError, match="smaller"):
        load_proving_key(path, dataclasses.replace(srs, k=srs.k - 1), device="cpu")
    # a key whose meta names no scheme predates SHPLONK and loads as GWC
    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    del meta["multiopen"]
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, **arrays)
    assert load_proving_key(legacy, srs, expect_table_fp=fp, device="cpu").vk.multiopen == "gwc"
