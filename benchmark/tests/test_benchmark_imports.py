"""What a run loads and prints: no JAX and no JAX package in its process,
a reference that imports nothing of the port, a result line of the agreed
keys, no device number from a CPU run, and no result without a card."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "paillier_halo2_tpu"}
PORT = "paillier_halo2_tpu_torch"


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_and_generator_import_nothing_of_the_port():
    paths = glob.glob(os.path.join(BENCH, "reference", "*.py")) + [os.path.join(BENCH, "generate.py")]
    for path in paths:
        assert PORT not in _imports(path), path
        assert PORT not in open(path).read(), path


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        "from benchmark import run\n"
        "from benchmark.tests.conftest import SMALL\n"
        "rc = run.main(['--workload', 'msm_2e20_uniform', '--seed', '2147483902', '--seconds', '0.3',"
        " '--trace', '1'], device='cpu', config_override=SMALL['msm_2e20_uniform'])\n"
        "mods = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'mods': mods}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail["rc"] == 0 and not (set(tail["mods"]) & FORBIDDEN)
    res = json.loads(lines[-2])
    keys = list(res)
    assert set(keys[:-1]) == {"correct", "attempted", "failed", "metrics", "device"}
    assert keys[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    # a CPU run writes no number under a device metric's name
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    device_metrics = {m["name"] for m in manifest["per_layer"] + manifest["end_to_end"]
                      if m["source"] == "device_trace"}
    assert not (set(res["metrics"]) & device_metrics)
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_without_a_card_a_run_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "msm_2e20_uniform",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    if p.returncode == 0:
        pytest.fail("a run without a card exited 0")
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "k14_add",
                        "--seed", "2147483903", "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 <= res["metrics"]["device_idle_pct.proof"]["value"] < 100
