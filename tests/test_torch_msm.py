"""The PyTorch port's Pippenger MSM (`msm/pippenger.py`, unsigned windows)
and KZG commitments (`plonk/kzg.py`) against the committed 2^10 fixture
`params_fixtures/bench_msm_expected_10.json`, the host oracle `ec/host`, and
the JAX package's window-key and schedule helpers.

The MSM runs the plain versions of K2 and K4 here on the CPU. A commitment is
a point, so every window width must give the same result.
"""
import json
import os
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ff import field_jax as fj
from paillier_halo2_tpu.msm import pippenger as jpip
from paillier_halo2_tpu_torch.ec import bn254
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.msm import pippenger as pip
from paillier_halo2_tpu_torch.plonk import kzg
from paillier_halo2_tpu_torch.plonk.srs import generate_srs

# pytest-xdist workers share the machine's cores: each worker's torch takes
# its share instead of all of them, so workers do not oversubscribe the CPU.
torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

FIXTURES = Path(__file__).resolve().parents[1] / "params_fixtures"


@pytest.fixture(scope="module")
def srs10():
    return generate_srs(10, b"", "cpu")


def _bench_scalars(n: int) -> list[int]:
    """bench.py's MSM scalar stream (`np.random.default_rng(1)`)."""
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 2**63, (4, n), dtype=np.int64)
    return [(int(x) | int(y) << 63 | int(z) << 126 | int(w) << 189) % ech.R
            for x, y, z, w in zip(*hi)]


@pytest.mark.parametrize("window_bits", [4, 8])
def test_msm_2e10_matches_fixture(srs10, window_bits):
    ex, ey = json.loads((FIXTURES / "bench_msm_expected_10.json").read_text())
    sd = f.pack_ints(_bench_scalars(1 << 10), "cpu")
    got = pip.msm_packed(srs10.g1_px, srs10.g1_py, srs10.g1_inf, sd, window_bits)
    assert got == (int(ex, 16), int(ey, 16))


@pytest.mark.parametrize("window_bits", [1, 2, 4, 8])
def test_msm_matches_host_oracle(window_bits):
    prng = random.Random(window_bits)
    points = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(40)]
    points[3] = None  # an infinity base
    scalars = [prng.randrange(ech.R) for _ in points]
    scalars[:4] = [0, 1, ech.R - 1, 5]
    scalars[10:14] = [7] * 4  # one bucket, several points
    got = pip.msm(points, scalars, "cpu", window_bits)
    assert got == ech.g1_msm(points, scalars)


def test_msm_edge_results():
    pts = [ech.g1_mul(ech.G1, s) for s in (3, 5, 11)]
    assert pip.msm(pts, [0, 0, 0], "cpu", 4) is None
    assert pip.msm(pts, [1, 0, 0], "cpu", 4) == pts[0]
    # 5*(3G) + (r-3)*(5G) cancels to infinity
    assert pip.msm(pts[:2], [5, ech.R - 3], "cpu", 8) is None
    assert pip.msm(pts, [5, 0, 0], "cpu", 8) == ech.g1_mul(ech.G1, 15)


@pytest.mark.parametrize("window_bits", [2, 4, 8])
def test_window_keys_match_jax(window_bits):
    scalars = _bench_scalars(64)
    keys_t = pip._keys_from_digits(f.pack_ints(scalars, "cpu"), window_bits)
    keys_j = jpip._keys_from_digits(jnp.asarray(fj.pack_ints(scalars)), window_bits)
    assert np.array_equal(keys_t.numpy(), np.asarray(keys_j).astype(np.int64))


@pytest.mark.parametrize("window_bits,s_base,s_cap", [(4, 1, 8), (8, 1, 8), (8, 8, 64)])
def test_sub_schedule_matches_jax(window_bits, s_base, s_cap):
    n_windows = 256 // window_bits
    assert pip._sub_schedule(n_windows, window_bits, s_base, s_cap) == jpip._sub_schedule(
        n_windows, window_bits, s_base, s_cap
    )


@pytest.mark.parametrize("s_base,s_cap", [(1, 1), (2, 16)])
def test_batched_commitments_match_single_msms(srs10, s_base, s_cap):
    """Several polynomials share one bucket loop; sub-accumulator counts
    change the schedule, never the result."""
    m = 64
    prng = random.Random(s_cap)
    polys = [[prng.randrange(ech.R) for _ in range(m)] for _ in range(3)]
    bases = srs10.g1_points(m)
    scalars = f.pack_ints([s for poly in polys for s in poly], "cpu").reshape(8, 3, m)
    got = pip.msm_packed_multi(
        srs10.g1_px[:, :m].contiguous(), srs10.g1_py[:, :m].contiguous(),
        srs10.g1_inf[:m].contiguous(), scalars.permute(1, 0, 2).contiguous(), 4, s_base, s_cap,
    )
    assert got == [ech.g1_msm(bases, poly) for poly in polys]


def test_kzg_commit_many(srs10):
    m = 32
    prng = random.Random(5)
    polys = [[prng.randrange(ech.R) for _ in range(m)] for _ in range(2)]
    mont = [f.to_mont(f.FR, f.pack_ints(p, "cpu")) for p in polys]
    bases = srs10.g1_points(m)
    want = [ech.g1_msm(bases, p) for p in polys]
    assert kzg.commit_many(srs10, mont, window_bits=4) == want
    assert kzg.commit(srs10, mont[1], window_bits=2) == want[1]
    assert kzg.commit_many(srs10, []) == []
    assert bn254.unpack_jacobian(bn254.pack_jacobian(bases[:3], "cpu")) == bases[:3]
