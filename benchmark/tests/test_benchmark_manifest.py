"""`BENCHMARK.json` against the benchmark's contract, and against the files
it names."""
from __future__ import annotations

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|width|bits$)")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in cmd:
        assert not w.startswith("/") and ".." not in w.split("/")
        if os.path.exists(os.path.join(ROOT, w)) and "/" in w:
            assert any(w.startswith(p + "/") for p in paths)


def test_names_and_units(manifest):
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for group in (manifest["configs"], manifest["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _text(m["layer"])


def test_cells_and_configs(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    assert {w["config"] for w in manifest["workloads"]} == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            data = json.load(fh)
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
    for w in manifest["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(pairs) // 4)


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        names = (m["name"], m["name"].split(".")[0])
        assert any(os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{n}.py")) for n in names)
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        assert m["workloads"]
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_layers_named_in_perf_md(manifest):
    with open(os.path.join(ROOT, "PERF.md")) as fh:
        perf = fh.read()
    for m in manifest["per_layer"]:
        assert f"`{m['layer']}`" in perf


def test_check_fits_the_clock(manifest):
    s = manifest["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_no_benchmark_file_is_one_git_leaves_out():
    """The root `.gitignore` leaves out `_*.py` but `__init__.py`: such a
    file would be missing from a checkout."""
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            assert not (f.startswith("_") and f.endswith(".py") and f != "__init__.py"), f


def test_traffic_files_hold_only_what_is_read(manifest):
    """Each traffic file's keys are those its system reads: no option that
    looks settable and is not."""
    keys = {"prover": {"statement", "keygen", "per_run", "per_step", "profiled_steps", "why"},
            "commit": {"coefficients", "reference_sample", "profiled_steps", "why"}}
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        with open(os.path.join(ROOT, configs[w["config"]]["file"])) as fh:
            system = json.load(fh)["system"]
        with open(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json")) as fh:
            traffic = json.load(fh)
        assert set(traffic) <= keys[system] and "profiled_steps" in traffic, w["traffic"]
