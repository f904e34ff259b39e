"""The PyTorch port's Pippenger MSM (`msm/pippenger.py`) on both routes —
unsigned windows (K4, K2) and signed windows (K5, K6, then K2) — and its KZG
commitments (`plonk/kzg.py`) against the committed 2^10 fixture
`params_fixtures/bench_msm_expected_10.json`, the host oracle `ec/host`, and
the JAX package's window-key and schedule helpers.

The MSM runs the plain versions of its kernels here on the CPU; a CPU
commitment runs the native engine. A commitment is a point, so every route
and window width must give the same result.
"""
import json
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ff import field_jax as fj
from paillier_halo2_tpu.msm import pippenger as jpip
from paillier_halo2_tpu_torch import native
from paillier_halo2_tpu_torch.ec import bn254
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.msm import pippenger as pip
from paillier_halo2_tpu_torch.plonk import kzg
from paillier_halo2_tpu_torch.plonk.srs import generate_srs

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
    assert kzg.commit_many(srs10, mont) == want
    assert kzg.commit(srs10, mont[1]) == want[1]
    assert kzg.commit_many(srs10, []) == []
    assert bn254.unpack_jacobian(bn254.pack_jacobian(bases[:3], "cpu")) == bases[:3]


def test_unsigned_buckets_match_jax_bit_for_bit(srs10, monkeypatch):
    """The unsigned route's buckets (the loop through `bucket_loop_plain`,
    the merge through K2 nodouble) equal the JAX package's
    `_bucket_accumulate` on its unsigned route in their canonical Jacobian
    bits, which holds each lane's add order to the reference's: 200 SRS
    bases, one flagged at infinity, the top 8 windows of width 4 at s_base
    2 (the top window's buckets take s = 8), so lanes add several points
    each and bucket 0 is empty."""
    monkeypatch.setenv("PAILLIER_TPU_LAZY", "0")
    n, c = 200, 4
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    scalars = [int.from_bytes(w.astype(np.uint32).tobytes(), "little") % ech.R for w in words]
    px, py = (t[:, :n].contiguous() for t in (srs10.g1_px, srs10.g1_py))
    pinf = srs10.g1_inf[:n].clone()
    pinf[7] = True
    keys = pip._keys_from_digits(f.pack_ints(scalars, "cpu"), c)[-8:]  # the top 8 windows
    subs = pip._sub_schedule(64, c, 2, 16)[-8:]
    assert subs[-1] == 8 and set(subs[:-1]) == {2}
    stats = {}
    got = pip._bucket_accumulate(px, py, pinf, keys, 1 << c, subs, stats=stats)
    assert stats["rounds"] > 4 and stats["lane_rounds"] > 3 * stats["lanes"]
    want = jpip._bucket_accumulate(
        jnp.asarray(f.to_ref_digits(px)), jnp.asarray(f.to_ref_digits(py)),
        jnp.asarray(pinf.numpy()), jnp.asarray(keys.numpy().astype(np.int32)), c, subs)
    for t, j in zip(got, want):
        assert np.array_equal(f.to_ref_digits(t), np.asarray(j, np.uint32))
    assert bool((got[2][:, :, 0] == 0).all())  # bucket 0: infinity in every window


# -- the signed route ------------------------------------------------------------


@pytest.mark.parametrize("c", [8, 9, 11])
def test_signed_keys_match_jax(c):
    scalars = _bench_scalars(61) + [0, 1, ech.R - 1]
    keys_t, negs_t = pip._signed_keys(f.pack_ints(scalars, "cpu"), c)
    keys_j, negs_j = jpip._signed_keys(jnp.asarray(fj.pack_ints(scalars)), c)
    assert np.array_equal(keys_t.numpy(), np.asarray(keys_j).astype(np.int64))
    assert np.array_equal(negs_t.numpy(), np.asarray(negs_j))
    for i, s in enumerate(scalars):  # the recoding is exact
        k, ng = keys_t[:, i].tolist(), negs_t[:, i].tolist()
        assert sum((-x if n else x) << (c * w) for w, (x, n) in enumerate(zip(k, ng))) == s


@pytest.mark.parametrize("c,s_base", [(8, 4), (8, 8), (9, 8), (11, 8), (11, 1)])
def test_signed_schedule_matches_jax(c, s_base):
    n_windows = -(-256 // c)
    assert pip._sub_schedule_signed(n_windows, c, s_base) == jpip._sub_schedule_signed(
        n_windows, c, s_base
    )


def test_signed_window_bits_match_jax(monkeypatch):
    monkeypatch.setenv("PAILLIER_TPU_LAZY", "1")  # the JAX package's accelerator route
    monkeypatch.delenv("PAILLIER_TPU_MSM_SIGNED", raising=False)
    for n in (1 << 10, (1 << 16) - 1, 1 << 16, (1 << 19) - 1, 1 << 19, 1 << 20):
        assert pip._signed_window_bits(n) == jpip._signed_window_bits(n)


def test_signed_msm_2e10_matches_fixture(srs10):
    ex, ey = json.loads((FIXTURES / "bench_msm_expected_10.json").read_text())
    sd = f.pack_ints(_bench_scalars(1 << 10), "cpu")
    stats = {}
    got = pip.msm_packed(srs10.g1_px, srs10.g1_py, srs10.g1_inf, sd, signed=True, stats=stats)
    assert got == (int(ex, 16), int(ey, 16))
    assert stats["lanes"] == pip._lanes_per_poly(*pip._sub_schedule_signed(32, 8, 4))
    assert stats["rounds"] > 0


@pytest.mark.parametrize("c", [3, 5])
def test_signed_msm_matches_host_oracle(c):
    prng = random.Random(c)
    points = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(40)]
    points[3] = None  # an infinity base
    scalars = [prng.randrange(ech.R) for _ in points]
    scalars[:4] = [0, 1, ech.R - 1, 5]
    scalars[10:14] = [7] * 4  # one bucket, several points
    scalars[20:22] = [ech.R - 7] * 2  # the same bucket, negated
    got = pip.msm(points, scalars, "cpu", c, signed=True)
    assert got == ech.g1_msm(points, scalars)
    assert pip.msm(points[:3], [0, 0, 0], "cpu", c, signed=True) is None


@pytest.mark.parametrize("big", [(1 << 256) - 1, 1 << 255])
def test_signed_route_rejects_scalars_above_r(srs10, big):
    m = 4
    sd = f.pack_ints([3, big, 5, 7], "cpu")
    bases = (srs10.g1_px[:, :m].contiguous(), srs10.g1_py[:, :m].contiguous(),
             srs10.g1_inf[:m].contiguous())
    with pytest.raises(ValueError, match="below r"):
        pip.msm_packed(*bases, sd, signed=True)
    assert pip.msm_packed(*bases, sd, signed=False) == ech.g1_msm(srs10.g1_points(m), [3, big, 5, 7])


def test_signed_batched_commitments_match_single_msms(srs10, monkeypatch):
    """Several polynomials share one bucket loop, or several when the lane
    bound splits them into groups; the result is the same."""
    m = 64
    prng = random.Random(9)
    polys = [[prng.randrange(ech.R) for _ in range(m)] for _ in range(3)]
    bases = srs10.g1_points(m)
    scalars = f.pack_ints([s for poly in polys for s in poly], "cpu").reshape(8, 3, m)
    args = (srs10.g1_px[:, :m].contiguous(), srs10.g1_py[:, :m].contiguous(),
            srs10.g1_inf[:m].contiguous(), scalars.permute(1, 0, 2).contiguous(), 4)
    want = [ech.g1_msm(bases, poly) for poly in polys]
    one_call = {}
    assert pip.msm_packed_multi(*args, signed=True, stats=one_call) == want
    monkeypatch.setattr(pip, "MAX_LANES", 1)  # one poly per call
    grouped = {}
    assert pip.msm_packed_multi(*args, signed=True, stats=grouped) == want
    assert grouped["lanes"] == one_call["lanes"] and grouped["rounds"] > one_call["rounds"] // 3


def test_cpu_commit_many_runs_native_and_equals_the_plain_msm(srs10, monkeypatch):
    m = 48
    prng = random.Random(6)
    polys = [[prng.randrange(ech.R) for _ in range(m)] for _ in range(2)]
    mont = [f.to_mont(f.FR, f.pack_ints(p, "cpu")) for p in polys]
    scalars = torch.stack([f.pack_ints(p, "cpu") for p in polys])
    plain = pip.msm_packed_multi(srs10.g1_px[:, :m].contiguous(), srs10.g1_py[:, :m].contiguous(),
                                 srs10.g1_inf[:m].contiguous(), scalars, 4)
    assert kzg.commit_many(srs10, mont) == plain
    monkeypatch.setattr(native, "lib", lambda: None)  # no native engine: raise, no fallback
    with pytest.raises(RuntimeError, match="native"):
        kzg.commit_many(srs10, mont)
