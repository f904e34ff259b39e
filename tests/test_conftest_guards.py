"""The guards the root `conftest.py` puts around the suite: the limit on
each phase of a test, the lock around the native build and the JAX
package's SRS cache, and the order and marks it gives the collected tests."""
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def guards(request):
    """The root `conftest.py` as pytest loaded it (every `conftest.py` here
    is a module named `conftest`, so the name does not find it)."""
    module = request.config.pluginmanager.get_plugin(str(ROOT / "conftest.py"))
    assert module is not None
    return module


_LIMIT = """
import importlib.util, signal, sys, time
import pytest
spec = importlib.util.spec_from_file_location("guards", {conftest!r})
guards = importlib.util.module_from_spec(spec)
spec.loader.exec_module(guards)
guards.LIMIT = 0.2
start = time.monotonic()
try:
    with guards.time_limit():
        time.sleep(30)
    print("not failed")
except pytest.fail.Exception as e:
    print("failed in time" if time.monotonic() - start < 10 else "failed late", e)
guards.LIMIT = 5.0
with guards.time_limit():
    armed = signal.getitimer(signal.ITIMER_REAL)[0]
    time.sleep(0.05)
    value = 42
print("in time", value, 0 < armed <= 5.0, signal.getitimer(signal.ITIMER_REAL)[0],
      signal.getsignal(signal.SIGALRM) is signal.SIG_DFL)
"""


@pytest.fixture(scope="module")
def limit_run(tmp_path_factory):
    """A fresh process runs `time_limit` with no limit around it: a body
    that sleeps past a 0.2-s limit, then one that ends inside a 5-s limit."""
    script = tmp_path_factory.mktemp("limit") / "limit.py"
    script.write_text(_LIMIT.format(conftest=str(ROOT / "conftest.py")))
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()


def test_limit_fails_a_body_that_runs_past_it(limit_run):
    assert limit_run[0].startswith("failed in time ran past the per-test limit of 0.2 s"), limit_run


def test_limit_leaves_a_body_in_time_alone(limit_run):
    # the body's value is kept, the timer was armed inside, and on exit the
    # timer is off and the handler is the one from before
    assert limit_run[1] == "in time 42 True 0.0 True", limit_run


_BUILD = """
import importlib.util, os, subprocess, sys, time
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("guards", {conftest!r})
guards = importlib.util.module_from_spec(spec)
spec.loader.exec_module(guards)
native_dir, me, other = sys.argv[1:]
# a submodule of the JAX package, so that its `..ff.host` resolves
spec = importlib.util.spec_from_file_location(
    "paillier_halo2_tpu._native_copy", os.path.join(native_dir, "__init__.py"),
    submodule_search_locations=[native_dir])
copy = importlib.util.module_from_spec(spec)
spec.loader.exec_module(copy)
compiles = []
run = subprocess.run
subprocess.run = lambda cmd, *a, **kw: compiles.append(cmd[0]) or run(cmd, *a, **kw)
open(os.path.join(native_dir, me), "w").close()
while not os.path.exists(os.path.join(native_dir, other)):
    time.sleep(0.01)
with guards.file_lock(native_dir):  # as `build_native` holds it
    lib = copy.lib()
print(compiles.count("g++"), "loaded" if lib is not None and lib.g1_msm_c is not None else "none")
"""


def test_two_processes_build_the_native_engine_once(tmp_path):
    """Both processes start the build at the same moment, under the lock, on
    a copy of the JAX package's `native/` with no library: one compiles,
    the other waits and loads the same library."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("__init__.py", "bn254.cpp"):
        shutil.copy(ROOT / "paillier_halo2_tpu" / "native" / name, native_dir / name)
    script = tmp_path / "build.py"
    script.write_text(_BUILD.format(root=str(ROOT), conftest=str(ROOT / "conftest.py")))
    env = {k: v for k, v in os.environ.items() if k != "PAILLIER_TPU_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, str(script), str(native_dir), me, other],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for me, other in (("ready0", "ready1"), ("ready1", "ready0"))]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    results = sorted(out.strip().splitlines()[-1] for out, _ in outs)
    assert results == ["0 loaded", "1 loaded"]  # one compile between them
    built = sorted(x.name for x in native_dir.iterdir() if x.name.startswith("_bn254_"))
    assert len(built) == 1 and built[0].endswith(".so"), built


def test_jax_srs_cache_is_whole_before_the_tests():
    """`pytest_configure` wrote the K=10 SRS cache before any test ran; it
    loads whole and holds the seed-b"" SRS: [1]G1, [tau]G1 and [tau]G2."""
    from paillier_halo2_tpu.ec import host as ech
    from paillier_halo2_tpu.plonk import srs

    z = np.load(srs._cache_path(10), allow_pickle=False)
    assert int(z["k"]) == 10
    assert z["g1_px"].shape[1] == z["g1_py"].shape[1] == z["g1_inf"].shape[0] == 1 << 10
    cached, tau = srs.read_or_create_srs(10), srs._dev_tau(b"")
    assert cached.g1_points(2) == [ech.G1, ech.g1_mul(ech.G1, tau)]
    assert cached.g2_tau == ech.g2_mul(ech.G2, tau)


def _item(nodeid):
    item = SimpleNamespace(nodeid=nodeid, path=Path(nodeid.split("::")[0]), marks=[])
    item.add_marker = item.marks.append
    return item


def test_longest_files_go_first_and_stay_whole(guards):
    first, second = (f"tests/{name}" for name in guards.LONGEST_FIRST[:2])
    names = ["tests/test_a.py::t1", "tests/test_a.py::t2", f"{second}::t1", f"{second}::t2",
             "tests/test_b.py::t1", f"{first}::t", "tests/test_c.py::t1"]
    items = [_item(n) for n in names]
    guards.pytest_collection_modifyitems(None, items)
    assert [i.nodeid for i in items] == [names[5], names[2], names[3], names[0], names[1],
                                         names[4], names[6]]


def test_slow_tests_are_marked_and_no_other(guards):
    items = [_item(n) for n in (*guards.SLOW, "tests/test_a.py::t1")]
    guards.pytest_collection_modifyitems(None, items)
    for item in items:
        assert [m.name for m in item.marks] == (["slow"] if item.nodeid in guards.SLOW else [])


def test_order_and_slow_lists_name_what_exists(guards):
    """Every file in the order exists once; every test marked slow exists
    and tests the JAX package alone."""
    tests = ROOT / "tests"
    assert len(set(guards.LONGEST_FIRST)) == len(guards.LONGEST_FIRST)
    for name in guards.LONGEST_FIRST:
        assert (tests / name).is_file(), name
    for nodeid in guards.SLOW:
        path, name = nodeid.split("::")
        text = (ROOT / path).read_text()
        assert f"def {name}(" in text, nodeid
        assert "paillier_halo2_tpu_torch" not in text, nodeid
