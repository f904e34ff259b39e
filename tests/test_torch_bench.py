"""The PyTorch port's main-path entry, `base_test().bench_builder`
(`harness/base_test.py`, `harness/bench.py`), end to end at k=10 on the CPU:
SRS created into an empty cache directory, keygen, witness synthesis, a
random-blinded proof, verification and the `BenchStats` it reports. On the
CPU the commitments run the native engine.
The encryption circuit's proof through the harness is held byte for byte
against the JAX package's (`torch_fixtures/bench_enc_k10.json`), with the
fixture's blinding seed passed in.
"""
import json
import random
from pathlib import Path

from paillier_halo2_tpu_torch.bignum.host import paillier_add_native, paillier_enc_native
from paillier_halo2_tpu_torch.harness import bench
from paillier_halo2_tpu_torch.harness.base_test import base_test
from paillier_halo2_tpu_torch.harness.circuits import (
    PaillierAddCipherInput,
    PaillierEncryptionInput,
    paillier_enc_add_test,
    paillier_enc_test,
)

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / "bench_enc_k10.json"


def test_bench_builder_k10_verifies(tmp_path):
    """The harness's main-path entry at k=10, on the add circuit: SRS created
    into an empty cache directory, keygen, witness, random-blinded proof,
    verify."""
    prng = random.Random(7)
    enc, limb = 16, 8
    n = prng.getrandbits(enc) | (1 << (enc - 1)) | 1
    g, c1, c2 = (prng.getrandbits(enc) for _ in range(3))
    inp = PaillierAddCipherInput(limb, enc, n, g, c1, c2, paillier_add_native(n, c1, c2))
    stats = (
        base_test().k(10).lookup_bits(9).expect_satisfied(True).device("cpu")
        .params_dir(str(tmp_path))
        .bench_builder(inp, inp, paillier_enc_add_test)
    )
    assert stats.verified
    assert (tmp_path / "kzg_bn254_dev_10.npz").exists()
    assert stats.proof_size > 0 and stats.proof_size % 32 == 0
    assert min(stats.srs_time, stats.keygen_vk_time, stats.proof_time) > 0
    assert "verified=True" in stats.pretty()


def test_bench_builder_enc_reports_the_reference_stats(tmp_path, monkeypatch):
    """`tests/test_bench_harness.py::test_bench_builder_enc` on the port: the
    encryption circuit at k=10 through the harness (shape discovery, the
    cached seed-b"" SRS, keygen, a fresh synthesis, proof, verify), with the
    fields the reference prints (`src/bench.rs:173-178`) and keygen split
    into its vk and pk halves. The harness draws fresh blinding; with the
    fixture's seed passed in, the proof equals the JAX package's bytes."""
    fx = json.loads(FIXTURE.read_text())
    prng = random.Random(14)
    enc, limb = 16, 8
    n = prng.getrandbits(enc) | (1 << (enc - 1)) | 1
    g, m, r = (prng.getrandbits(enc) for _ in range(3))
    inp = PaillierEncryptionInput(enc, limb, n, g, m, r, paillier_enc_native(n, g, m, r))
    assert (fx["k"], fx["lookup_bits"], fx["enc_bits"], fx["limb_bits"]) == (10, 9, enc, limb)
    assert fx["inputs"] == {"n": n, "g": g, "m": m, "r": r, "res": inp.res}
    proofs = []
    create_proof = bench.create_proof

    def seeded(pk, table, checks):
        proofs.append(create_proof(pk, table, fx["blinding_seed"].encode(), checks=checks))
        return proofs[-1]

    monkeypatch.setattr(bench, "create_proof", seeded)
    stats = (
        base_test().k(10).lookup_bits(9).device("cpu").params_dir(str(tmp_path))
        .bench_builder(inp, inp, paillier_enc_test)
    )
    assert len(proofs) == 1 and proofs[0].hex() == fx["proof_hex"]
    assert stats.verified and stats.proof_size == len(proofs[0])
    assert abs(stats.keygen_time - (stats.vk_time + stats.pk_time)) < 1e-9
    assert stats.config_params.k == 10 and stats.config_params.num_advice == fx["num_advice"]
    text = stats.pretty()
    assert "proof size" in text and "config params" in text
