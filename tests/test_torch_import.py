"""The PyTorch port imports without JAX, Triton, nvcc or a card, builds
nothing at import time, builds and reads only files of its own package, and
its entry points default to the card and fail where there is none instead of
falling back to the CPU.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paillier_halo2_tpu_torch import native
from paillier_halo2_tpu_torch.benches import (
    bench,
    bench_add,
    bench_batch,
    bench_bigenc,
    bench_scaling,
    profile_chip,
    profile_proof,
)
from paillier_halo2_tpu_torch.entry import dryrun_multichip, entry
from paillier_halo2_tpu_torch.gadgets.context import Context
from paillier_halo2_tpu_torch.harness.base_test import base_test
from paillier_halo2_tpu_torch.mesh.sharding import make_mesh
from paillier_halo2_tpu_torch.mock import prover as mock
from paillier_halo2_tpu_torch.msm import pippenger
from paillier_halo2_tpu_torch.plonk import srs
from paillier_halo2_tpu_torch.plonk.keygen import keygen
from paillier_halo2_tpu_torch.plonk.serialize import load_proving_key, save_proving_key
from paillier_halo2_tpu_torch.utils import kernels

ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
import paillier_halo2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
if {every}:
    for name in names:
        importlib.import_module(name)
    # the MockProver's entry points run on the CPU without JAX too
    from paillier_halo2_tpu_torch.entry import dryrun_multichip, entry
    from paillier_halo2_tpu_torch.harness.base_test import base_test
    import contextlib, io
    fn, args = entry(device="cpu")
    assert not any(m.any() for m in fn(*args))
    with contextlib.redirect_stdout(io.StringIO()):  # the route line
        out = base_test().k(8).lookup_bits(4).device("cpu").run(
            lambda ctx, rc: rc.range_check(ctx.load_witness([3, 9]), 4))
    assert out.mock.satisfied
from paillier_halo2_tpu_torch.utils import kernels
assert {{"paillier_halo2_tpu_torch.mock.prover", "paillier_halo2_tpu_torch.entry",
         "paillier_halo2_tpu_torch.plonk.serialize", "paillier_halo2_tpu_torch.mesh.msm",
         "paillier_halo2_tpu_torch.mesh.ntt", "paillier_halo2_tpu_torch.plonk.distributed",
         "paillier_halo2_tpu_torch.utils.trace", "paillier_halo2_tpu_torch.benches.bench",
         "paillier_halo2_tpu_torch.benches.bench_add", "paillier_halo2_tpu_torch.benches.bench_batch",
         "paillier_halo2_tpu_torch.benches.bench_bigenc",
         "paillier_halo2_tpu_torch.benches.bench_scaling",
         "paillier_halo2_tpu_torch.benches.profile_proof",
         "paillier_halo2_tpu_torch.benches.profile_chip",
         "paillier_halo2_tpu_torch.benches.bench_cpu_proxy"}} <= set(names)
assert len(names) > 40, names
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "paillier_halo2_tpu" not in sys.modules
assert "triton" not in sys.modules
assert kernels._lib is None  # nothing was built
print("ok", len(names))
"""


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.mark.parametrize("every", [False, True], ids=["package", "every_module"])
def test_import_pulls_in_no_jax(every):
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.format(every=every)],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """With no CUDA device (here), or with none of the repo beside it, the
    smoke script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = _clean_env()
    if where == "alone":
        env.pop("PYTHONPATH")
    res = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "CUDA_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_source_tag_covers_every_kernel_source():
    names = {p.name for p in (ROOT / "paillier_halo2_tpu_torch" / "csrc").iterdir()}
    assert names == set(kernels.SOURCES) | set(kernels.HEADERS)
    assert len(kernels._source_tag()) == 16


def test_built_and_read_files_lie_in_the_port():
    """The kernel sources and the native engine's C++ are the port's own
    files, and no module of the port names the JAX package's directory."""
    pkg = ROOT / "paillier_halo2_tpu_torch"
    sources = [Path(kernels.CSRC) / n for n in kernels.SOURCES + kernels.HEADERS]
    for path in sources + [Path(native._SRC)]:
        assert path.resolve().is_relative_to(pkg.resolve()), path
        assert path.exists(), path
    for py in pkg.rglob("*.py"):
        assert not re.search(r"""["']paillier_halo2_tpu["']""", py.read_text()), py


def _empty_circuit(ctx, range_chip, inp):
    pass


def _empty_table():
    ctx = Context()
    ctx.load_witness([1])
    return ctx.finalize()


@pytest.mark.parametrize("name", ["generate_srs", "read_or_create_srs", "msm", "bench_builder",
                                  "mock_prove_torch", "mock_prove_chunked", "base_test_run", "entry",
                                  "keygen_gwc", "save_proving_key", "load_proving_key",
                                  "make_mesh", "dryrun_multichip", "bench", "bench_add",
                                  "bench_batch", "bench_bigenc", "bench_scaling",
                                  "profile_proof", "profile_chip"])
def test_entry_points_default_to_the_card(name, tmp_path):
    """Called without a device, each entry point asks for the card and
    raises where there is none; it never runs on the CPU instead. keygen
    and save_proving_key work on the SRS's device, and an SRS made without
    a device is asked of the card; load_proving_key asks for the card
    itself, even given an SRS on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default-device call would run")
    calls = {
        "generate_srs": lambda: srs.generate_srs(4),
        "read_or_create_srs": lambda: srs.read_or_create_srs(4, params_dir=str(tmp_path)),
        "msm": lambda: pippenger.msm([None, None], [1, 2]),
        "bench_builder": lambda: base_test().k(4).lookup_bits(3).params_dir(str(tmp_path))
        .bench_builder(None, None, _empty_circuit),
        "mock_prove_torch": lambda: mock.mock_prove_torch(_empty_table(), 3),
        "mock_prove_chunked": lambda: mock.mock_prove_chunked(_empty_table(), 3),
        "base_test_run": lambda: base_test().k(4).lookup_bits(3).run(lambda ctx, rc: None),
        "entry": entry,
        "keygen_gwc": lambda: keygen(_empty_table(), 4, 3, srs.generate_srs(4), multiopen="gwc"),
        "save_proving_key": lambda: save_proving_key(
            keygen(_empty_table(), 4, 3, srs.generate_srs(4)), str(tmp_path / "pk.npz")),
        "load_proving_key": lambda: load_proving_key(str(tmp_path / "pk.npz"),
                                                     srs.generate_srs(4, device="cpu")),
        "make_mesh": lambda: make_mesh(1),
        "dryrun_multichip": lambda: dryrun_multichip(2),
        "bench": lambda: bench.main(["--params-dir", str(tmp_path), "--key-dir", str(tmp_path)]),
        "bench_add": lambda: bench_add.main(["4", "--params-dir", str(tmp_path),
                                             "--key-dir", str(tmp_path)]),
        "bench_batch": lambda: bench_batch.main(["2", "4", "3", "8", "--params-dir", str(tmp_path)]),
        "bench_bigenc": lambda: bench_bigenc.main(["8", "4", "--params-dir", str(tmp_path)]),
        "bench_scaling": lambda: bench_scaling.main(["4", "--params-dir", str(tmp_path)]),
        "profile_proof": lambda: profile_proof.main(["4", "1", "--params-dir", str(tmp_path)]),
        "profile_chip": lambda: profile_chip.main(["msm", "--msm-log2", "4",
                                                  "--params-dir", str(tmp_path)]),
    }
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[name]()
    assert not list(tmp_path.iterdir())  # nothing was written on the way
