"""The port's bench entry points (`paillier_halo2_tpu_torch/benches/`) and
its trace utilities against the JAX package and its root scripts, on the
CPU at small sizes:

- `bench_batch.synthesize` (`harness.circuits.paillier_enc_batch` in a
  kept witness pool) builds the table the JAX package builds with
  `bench_batch.py:29-50`'s recipe;
- a K=10 batched proof (B=2) equals `tests/torch_fixtures/batch_k10.json`
  (written by `make_slice_fixture.py batch`), byte for byte;
- `bench_bigenc`'s circuit and its layout's column count equal the JAX
  package's;
- `bench.main` validates its MSM against the committed fixture, proves and
  verifies, and prints `bench.py`'s keys after each phase;
- `bench_scaling` gives the unsharded MSM's point at every shard count;
- `profile_chip`'s MSM phase (the whole call and its parts) gives the
  committed fixture's point;
- `bench_cpu_proxy` proves and verifies and prints the keys of the root
  `bench_cpu_proxy.py`, and `bench --cpu-proxy-json` reports the ratio to
  it (with a stand-in prover: the proof is not what is checked there);
- `PhaseTimer(json_path=)` writes the JAX package's keys and
  `profile_section` writes a trace.

No JAX proof is computed here: the JAX bytes come from the fixture.
"""
import ast
import json
import random
from pathlib import Path

import pytest
import torch

from paillier_halo2_tpu.bignum.host import paillier_enc_native as jax_enc_native
from paillier_halo2_tpu.gadgets.context import Context as JaxContext
from paillier_halo2_tpu.gadgets.context import SinglePhaseCoreManager as JaxPool
from paillier_halo2_tpu.gadgets.range import RangeChip as JaxRangeChip
from paillier_halo2_tpu.harness.circuits import PaillierEncryptionInput as JaxEncInput
from paillier_halo2_tpu.harness.circuits import paillier_enc_test as jax_enc_test
from paillier_halo2_tpu.plonk.layout import assign_layout as jax_assign_layout
from paillier_halo2_tpu.utils.trace import PhaseTimer as JaxPhaseTimer
from paillier_halo2_tpu_torch import benches
from paillier_halo2_tpu_torch.benches import (
    bench,
    bench_batch,
    bench_bigenc,
    bench_cpu_proxy,
    bench_scaling,
    profile_chip,
)
from paillier_halo2_tpu_torch.msm import pippenger
from paillier_halo2_tpu_torch.plonk.keygen import keygen
from paillier_halo2_tpu_torch.plonk.layout import assign_layout
from paillier_halo2_tpu_torch.plonk.prover import create_proof
from paillier_halo2_tpu_torch.plonk.srs import read_or_create_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof
from paillier_halo2_tpu_torch.utils.trace import PhaseTimer, profile_section

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "torch_fixtures" / "batch_k10.json"
K, LOOKUP_BITS = 10, 9


@pytest.fixture(scope="module")
def params_dir(tmp_path_factory):
    """One SRS cache for the module: the seed-b"" SRS at K=10 is made once."""
    return str(tmp_path_factory.mktemp("params"))


def jax_synth_one(ctx, i, lookup_bits, enc_bits, limb_bits, seed=1):
    """`bench_batch.py:29-50`'s `synth_one` on the JAX package."""
    rng = random.Random(seed + i)
    n = rng.getrandbits(enc_bits) | (1 << (enc_bits - 1)) | 1
    g, m, r = (rng.getrandbits(enc_bits) for _ in range(3))
    inp = JaxEncInput(enc_bits=enc_bits, limb_bits=limb_bits, n=n, g=g, m=m, r=r,
                      res=jax_enc_native(n, g, m, r))
    jax_enc_test(ctx, JaxRangeChip(ctx, lookup_bits), inp)


def assert_same_table(port, ref):
    fields = ("values", "gates", "copy_a", "copy_b", "const_idx", "const_val", "lookups",
              "publics")
    for name in fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.shape == b.shape, name
        assert [int(x) for x in a] == [int(x) for x in b], name


def test_synth_one_through_the_pool_matches_jax():
    table, workers, pool_error = bench_batch.synthesize(3, LOOKUP_BITS, 16, 8)
    assert pool_error is None and 1 <= workers <= 3
    ref = JaxPool.synth_parallel(
        lambda ctx, i: jax_synth_one(ctx, i, LOOKUP_BITS, 16, 8), 3, n_workers=1)
    assert_same_table(table, ref)


def test_synth_parallel_reports_serial_synthesis():
    """A closure cannot reach spawn workers: synthesis runs serially and
    `stats` says so."""
    from paillier_halo2_tpu_torch.gadgets.context import SinglePhaseCoreManager

    base = 5
    stats = {}
    table = SinglePhaseCoreManager.synth_parallel(lambda ctx, i: ctx.load_witness([base + i]), 2,
                                                  n_workers=2, stats=stats)
    assert {key: stats[key] for key in ("workers", "pool_error", "instances", "rows", "spawn_s")} \
        == {"workers": 1, "pool_error": None, "instances": 2, "rows": 2, "spawn_s": 0.0}
    assert [int(v) for v in table.values] == [5, 6]


def test_batched_proof_matches_the_jax_fixture(params_dir):
    fx = json.loads(FIXTURE.read_text())
    table, _, pool_error = bench_batch.synthesize(2, fx["lookup_bits"], fx["enc_bits"],
                                                  fx["limb_bits"])
    assert pool_error is None
    assert table.n_rows == fx["n_rows"]
    srs = read_or_create_srs(fx["k"], device="cpu", params_dir=params_dir)
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs)
    assert pk.vk.num_advice == fx["num_advice"]
    proof = create_proof(pk, table, fx["blinding_seed"].encode())
    assert proof.hex() == fx["proof_hex"]
    assert verify_proof(pk.vk, srs, proof)


def test_bigenc_table_and_layout_match_jax():
    enc = 64
    table = bench_bigenc.circuit_table(enc, LOOKUP_BITS)
    prng = random.Random(bench_bigenc.SEED)
    n = prng.getrandbits(enc) | (1 << (enc - 1)) | 1
    g, m, r = (prng.getrandbits(enc) for _ in range(3))
    ctx = JaxContext()
    jax_enc_test(ctx, JaxRangeChip(ctx, LOOKUP_BITS),
                 JaxEncInput(enc_bits=enc, limb_bits=bench_bigenc.LIMB, n=n, g=g, m=m, r=r,
                             res=jax_enc_native(n, g, m, r)))
    ref = ctx.finalize()
    assert_same_table(table, ref)
    port_layout = assign_layout(table, K, LOOKUP_BITS)
    ref_layout = jax_assign_layout(ref, K, LOOKUP_BITS)
    assert port_layout.num_advice == ref_layout.num_advice > 1
    assert port_layout.num_lookup_advice == ref_layout.num_lookup_advice


def bench_py_keys() -> set:
    """The keys the root `bench.py` writes into its result line, read from its
    source: the line's own, `extras[...] =` targets and `extras.update(...)`
    keywords."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = {"metric", "value", "unit", "vs_baseline"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and getattr(node.value, "id", None) == "extras":
            keys.add(node.slice.value)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "update" \
                and getattr(node.func.value, "id", None) == "extras":
            keys.update(kw.arg for kw in node.keywords)
    return keys


def test_bench_main_on_the_cpu(params_dir, tmp_path, capsys):
    out = bench.main(["--device", "cpu", "--msm-log2", "10", "--mulmod-log2", "10",
                      "--proof-k", str(K), "--proof-enc", "8", "--proof-limb", "4",
                      "--key-dir", str(tmp_path), "--params-dir", params_dir])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["last_phase_done"] for x in lines] == [
        "start", "mulmod", "mulmod_lazy", "msm", "keygen", "proof_cold", "final"]
    assert lines[-1] == out
    assert out["msm_valid"] is True and out["proof_verified"] is True
    assert out["proof_k"] == K and out["value"] > 0
    # a fresh key cache: no keygen_cached; no phase timed out
    left_out = {"vs_baseline", "keygen_cached", "cpu_proxy_proof_s", "cpu_proxy_cpus",
                "tpu_speedup_vs_cpu_proxy"}
    want = {key for key in bench_py_keys() - left_out if not key.endswith("_timeout")}
    assert set(out) == want
    # no device bandwidth on the CPU
    assert out["hbm_copy_gbps_measured"] is None and out["mulmod_pct_of_spec_bw"] is None


def root_script_keys(name: str, target: str) -> set:
    """The keys of the dict literal a root script assigns to `target`."""
    tree = ast.parse((ROOT / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == target \
                and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no {target} = {{...}} in {name}")


def test_bench_cpu_proxy_proves_with_the_jax_keys(params_dir, tmp_path):
    fixtures = sorted((ROOT / "params_fixtures").iterdir())
    out_path = tmp_path / "proxy.json"
    line = bench_cpu_proxy.main([str(K), "--enc", "8", "--limb", "4", "--out", str(out_path),
                                 "--params-dir", params_dir])
    assert line["verified"] is True and line["backend"] == "cpu+native"
    assert (line["k"], line["enc_bits"]) == (K, 8) and line["proof_s"] > 0
    assert set(line) == root_script_keys("bench_cpu_proxy.py", "out")
    assert json.loads(out_path.read_text()) == line
    assert sorted((ROOT / "params_fixtures").iterdir()) == fixtures  # nothing written there


@pytest.mark.parametrize("with_proxy", [True, False], ids=["with-proxy", "without"])
def test_bench_reports_the_cpu_proxy_ratio_only_when_asked(params_dir, tmp_path, monkeypatch,
                                                           with_proxy):
    """The MSM, keygen and prover stand in (their keys fixed), so that the
    run checks the report alone."""
    monkeypatch.setattr(pippenger, "msm_packed", lambda *a, **kw: None)
    monkeypatch.setattr(benches, "cached_keygen", lambda *a: (None, 1.5))
    monkeypatch.setattr(benches, "prove_verify", lambda *a, **kw: (
        {"h2d": 1, "d2h": 1, "verified": True, "proof_cold_s": 3.0, "proof_s": 2.0,
         "verify_s": 0.5, "proof_bytes": 1, "proofs_per_sec": 0.5}, b""))
    proxy = tmp_path / "proxy.json"
    proxy.write_text(json.dumps({"backend": "cpu+native", "k": K, "enc_bits": 8, "proof_s": 7.0,
                                 "cpus": 4}))
    argv = ["--device", "cpu", "--msm-log2", "4", "--mulmod-log2", "4", "--proof-k", str(K),
            "--proof-limb", "4", "--params-dir", params_dir]
    out = bench.main(argv + ["--proof-enc", "8"]
                     + (["--cpu-proxy-json", str(proxy)] if with_proxy else []))
    keys = {"cpu_proxy_proof_s", "cpu_proxy_cpus", "speedup_vs_cpu_proxy"}
    if with_proxy:
        assert {key: out[key] for key in keys} == {"cpu_proxy_proof_s": 7.0, "cpu_proxy_cpus": 4,
                                                   "speedup_vs_cpu_proxy": 3.5}
    else:
        assert not keys & set(out)
    with pytest.raises(ValueError, match="enc_bits=8"):  # another width: refused at once
        bench.main(argv + ["--proof-enc", "16", "--cpu-proxy-json", str(proxy)])


def test_profile_chip_msm_matches_the_fixture(params_dir):
    out = profile_chip.main(["msm", "--msm-log2", str(K), "--device", "cpu",
                             "--params-dir", params_dir])
    assert out["timer"] == "host_clock" and out["card"] is None
    msm = out["msm"]
    assert msm["valid"] is True and msm["log2"] == K
    assert list(msm["parts_ms"]) == ["recode", "sort_and_lane_table", "bucket_loop", "merge",
                                     "window_sums", "horner"]


def test_bench_scaling_on_cpu_shards(params_dir):
    out = bench_scaling.main(["8", "--device", "cpu", "--shards", "4", "--params-dir", params_dir])
    assert out["all_equal"] is True
    assert set(out["times_s"]) == {"1", "2", "4", "2x2"}
    assert set(out["cards"].values()) == {0} and "not scale-out" in out["note"]


def test_phase_timer_json_has_the_jax_keys(tmp_path, monkeypatch):
    path = tmp_path / "marks.jsonl"
    timer = PhaseTimer("prover", json_path=str(path))
    timer.mark("a")
    timer.mark("b")
    ours = [json.loads(x) for x in path.read_text().splitlines()]
    ref_path = tmp_path / "jax.jsonl"
    monkeypatch.setenv("PAILLIER_TPU_TRACE_JSON", str(ref_path))
    JaxPhaseTimer("prover").mark("a")
    ref = json.loads(ref_path.read_text().splitlines()[0])
    assert [set(x) for x in ours] == [set(ref)] * 2
    assert [(x["section"], x["phase"]) for x in ours] == [("prover", "a"), ("prover", "b")]
    assert [label for label, _, _ in timer.marks] == ["a", "b"]


def test_profile_section_writes_a_trace(tmp_path):
    with profile_section("sec", None) as off:
        pass
    assert off.path is None
    with profile_section("sec", str(tmp_path)) as sec:
        torch.ones(64).add_(1)
    assert Path(sec.path).parent == tmp_path / "sec"
    assert "traceEvents" in json.loads(Path(sec.path).read_text())
