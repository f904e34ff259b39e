"""Guards around the test suite under `tests/` (`tests/conftest.py` sets up
the JAX package's CPU mesh; this file keeps the run inside its time limit).

The suite runs under pytest-xdist, one file per worker (`--dist loadfile`):
- the files that take longest start first (`LONGEST_FIRST`; xdist's own
  reorder, which puts the files with the most tests first, is turned off);
- every setup, call and teardown of a test has a limit (`LIMIT`);
- the native engines are built once, and the JAX package's K=10 SRS cache
  is written once, before any worker starts (`file_lock`);
- the reference-only tests in `SLOW` are marked slow;
- each worker's torch takes its share of the cores.
"""
import contextlib
import faulthandler
import fcntl
import hashlib
import os
import signal
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

TESTS = Path(__file__).resolve().parent / "tests"

# pytest-xdist workers share the machine's cores: each worker's torch takes
# its share instead of all of them, so workers do not oversubscribe the CPU.
torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)


@contextlib.contextmanager
def file_lock(key: str):
    """Hold an exclusive `flock` named by `key` (a path) across processes.

    The lock file lives in `tempfile.gettempdir()`, named by a hash of
    `key`; closing the file releases the lock."""
    tag = hashlib.blake2b(os.path.abspath(key).encode(), digest_size=8).hexdigest()
    with open(os.path.join(tempfile.gettempdir(), f"paillier-tests-{tag}.lock"), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield


def build_native():
    """Build (on first use) and load both packages' native engines, one
    process at a time.

    The JAX package builds `_bn254_<hash>.so` through one temporary name,
    `so + ".tmp"`, in every process, so two workers building at once can
    lose each other's file and keep `lib()` None for life. Under the lock
    the first process builds and the others load its library; `lib()`
    caches per process, so no later call builds. The port builds through a
    per-pid name and needs no lock, but building it here too (in a second
    thread) spares the workers a compile each. Returns the two handles
    (None where a build failed)."""
    from paillier_halo2_tpu import native as jax_native
    from paillier_halo2_tpu_torch import native as port_native

    with file_lock(os.path.dirname(jax_native.__file__)), ThreadPoolExecutor(2) as pool:
        return tuple(pool.map(lambda m: m.lib(), (jax_native, port_native)))


def create_jax_srs(k: int = 10):
    """Write the JAX package's seed-b"" SRS cache for `k`, which the suite's
    K=10 proofs read. `read_or_create_srs` writes `params/kzg_bn254_dev_<k>.npz`
    in place (`np.savez`), so a worker that found the file while another
    wrote it would load a torn file; made here, before any worker starts,
    the workers only read it."""
    from paillier_halo2_tpu.plonk import srs

    with file_lock(srs._cache_path(k)):
        srs.read_or_create_srs(k)


def _runs_tests(config) -> bool:
    """Whether this run collects from `tests/` (the guards leave other
    folders' runs, such as `benchmark/tests`, alone)."""
    for arg in config.args:
        path = (config.invocation_params.dir / arg.split("::")[0]).resolve()
        if path == TESTS or TESTS in path.parents or path in TESTS.parents:
            return True
    return False


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    if not _runs_tests(config):
        return
    jobs = [build_native]
    if not hasattr(config, "workerinput"):  # the controller, before any worker starts
        jobs.append(create_jax_srs)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for done in [pool.submit(job) for job in jobs]:
            done.result()


# The limit of each setup, call and teardown of a test, in seconds: about 1.5
# times the longest phase of a cold run (`test_instance.py`'s fixture, 938 s).
LIMIT = 1400.0


@contextlib.contextmanager
def time_limit():
    """Fail the code inside after `LIMIT` seconds (read at entry).

    `faulthandler` dumps every thread's stack at the limit even where the
    main thread sits in native code; the `ITIMER_REAL` handler fails the
    test as soon as Python runs again. Both are disarmed on exit."""
    limit = LIMIT

    def expire(signum, frame):
        pytest.fail(f"ran past the per-test limit of {limit:g} s (conftest.py LIMIT)")

    prev_handler = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit, exit=False)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, prev_handler)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with time_limit():
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit():
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with time_limit():
        return (yield)


# The longest modules of a cold run (2026-10-18, 8 cores, `-n 6 --dist
# loadfile`, the tests in SLOW left out), longest first: seconds from the
# first test's start to the last test's end. They go to the head of the
# collection; every other module keeps its place, and each still runs whole
# on one worker.
LONGEST_FIRST = (
    "test_instance.py",  # 945 s
    "test_pallas_kernels.py",  # 706 s
    "test_plonk.py",  # 624 s
    "test_torch_distributed.py",  # 360 s
    "test_lazy_mont.py",  # 323 s
    "test_big_geometry.py",  # 297 s
    "test_torch_msm.py",  # 275 s
    "test_msm.py",  # 266 s
    "test_torch_benches.py",  # 258 s
    "test_mesh.py",  # 237 s
    "test_multihost.py",  # 208 s
    "test_torch_selfcheck.py",  # 130 s
)

# Tests of the JAX package alone, marked slow to keep the run inside its
# limit, with the CPU-seconds each took in a cold run of the suite (alone,
# where noted). The test of the port named above each makes up for it.
SLOW = (
    # test_torch_distributed.py::test_single_device_key_proves_over_a_mesh_of_8
    "tests/test_distributed.py::test_sharded_proof_verifies_and_matches_single_chip",  # 3762
    # test_torch_selfcheck.py::test_fused_gate_slab_matches_its_formula_pointwise
    "tests/test_fused_quotient.py::test_fused_quotient_matches_eager",  # 2223 alone
    # test_torch_gadgets.py::test_merged_tables_with_publics_match_jax
    "tests/test_witness_pool.py::test_merged_pool_proof_verifies",  # 1552
    # test_torch_serialize.py::test_gwc_key_round_trip_proves_the_gwc_fixture
    "tests/test_serialize.py::test_pk_roundtrip_proof_verifies",  # 1378
    # test_torch_bench.py::test_bench_builder_enc_reports_the_reference_stats
    "tests/test_bench_harness.py::test_bench_builder_enc",  # 1086
    # test_torch_selfcheck.py::test_multicolumn_proof_passes_every_check
    "tests/test_plonk.py::test_quotient_degree_selfcheck_multicolumn",  # 752
)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    rank = {name: i for i, name in enumerate(LONGEST_FIRST)}
    items.sort(key=lambda item: rank.get(item.path.name, len(rank)))
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
