"""The MSM's two loop kernels on the CPU: the window sums
(`ec/point_kernels.window_sums`) and the signed bucket loop
(`ec/lazy_point.bucket_loop_lazy`), through their plain versions, against
the JAX package's `_window_sums` and `_bucket_impl` (XLA and Pallas
interpret mode on the CPU), and the wrappers' input checks.

The kernels themselves are held against these plain versions on the card in
`test_torch_cuda.py` and by `chip_smoke.py`.
"""
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ec import bn254 as jb
from paillier_halo2_tpu.ff import field_jax as fj
from paillier_halo2_tpu.msm import pippenger as jpip
from paillier_halo2_tpu_torch.ec import bn254 as tb
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ec import lazy_point as lp
from paillier_halo2_tpu_torch.ec import point_kernels as pk
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.msm import pippenger as pip

torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

Q = ech.Q
RM = (1 << 256) % Q


def _buckets(n_buckets: int, seed: int):
    """Montgomery Jacobian int columns for 2 windows of n_buckets random
    points with random Z, and in window 0: infinity buckets (both encodings),
    two equal neighbours (the scan's first step doubles one) and a P / -P
    pair of neighbours (that step cancels it)."""
    prng = random.Random(seed)
    pts = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(2 * n_buckets)]
    pts[0] = None
    pts[2] = None
    pts[6] = pts[5]
    pts[4] = ech.g1_neg(pts[3])
    cols = ([], [], [])
    for i, pt in enumerate(pts):
        if pt is None:
            vals = (1, 1, 0) if i == 2 else (0, 0, 0)
        else:
            z = prng.randrange(1, Q)
            vals = (pt[0] * z * z % Q, pt[1] * z * z * z % Q, z)
        for c, v in zip(cols, vals):
            c.append(v * RM % Q)
    return cols


@pytest.mark.parametrize("n_buckets", [9, 17])
def test_window_sums_plain_matches_jax(n_buckets):
    cols = _buckets(n_buckets, n_buckets)
    tp = tuple(f.pack_ints(c, "cpu").reshape(8, 2, n_buckets) for c in cols)
    jp = tuple(jnp.asarray(fj.pack_ints(c)).reshape(32, 2, n_buckets) for c in cols)
    got = pk.window_sums(*tp)  # a CPU tensor: the plain version
    want = jpip._window_sums(jp, n_buckets)
    for t, j in zip(got, want):
        assert np.array_equal(f.to_ref_digits(t), np.asarray(j, np.uint32))
    # and the sums are right: T_w = sum_b b * B_{w,b}
    pts = tb.unpack_jacobian(tuple(c.reshape(8, -1) for c in tp))
    for w, tw in enumerate(tb.unpack_jacobian(got)):
        acc = None
        for b in range(1, n_buckets):
            acc = ech.g1_add(acc, ech.g1_mul(pts[w * n_buckets + b], b) if pts[w * n_buckets + b] else None)
        assert tw == acc


def test_signed_bucket_loop_matches_jax(monkeypatch):
    """The signed route's bucket sums (the loop through
    `bucket_loop_lazy_plain`, the merge through `merge_lazy_plain`, one
    canonicalisation) equal the JAX package's `_bucket_impl` on its lazy
    route in their canonical Jacobian bits (X, Y and Z, infinities
    included), and so as affine points: 64 bases, one at infinity, c = 10,
    whose top window's 15 buckets take s = 64 sub-accumulators each."""
    monkeypatch.setenv("PAILLIER_TPU_LAZY", "1")
    prng = random.Random(22)
    n, c = 64, 10
    pts = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(n)]
    pts[3] = None
    scalars = [prng.randrange(ech.R) for _ in range(n)]
    scalars[5] = 0
    n_buckets = (1 << (c - 1)) + 1
    keys_t, neg_t = pip._signed_keys(f.pack_ints(scalars, "cpu"), c)
    subs, bcaps = pip._sub_schedule_signed(keys_t.shape[0], c, 1)
    assert (subs[-1], bcaps[-1]) == (64, 15)
    px, py, pinf = tb.pack_affine(pts, "cpu")
    got = pip._bucket_accumulate(px, py, pinf, keys_t, n_buckets, subs, bcaps, neg_t)
    jx, jy, jinf = jb.pack_affine(pts)
    keys_j, neg_j = jpip._signed_keys(jnp.asarray(fj.pack_ints(scalars)), c)
    want = jpip._bucket_impl(jnp.asarray(jx), jnp.asarray(jy), jnp.asarray(jinf), keys_j, neg_j,
                             n_buckets, subs, bcaps)
    for t, j in zip(got, want):
        assert np.array_equal(f.to_ref_digits(t), np.asarray(j, np.uint32))
    got_pts = tb.unpack_jacobian(tuple(t.reshape(8, -1) for t in got))
    want_pts = jb.unpack_jacobian(tuple(j.reshape(32, -1) for j in want))
    assert got_pts == want_pts
    assert sum(p is not None for p in got_pts) > n // 2


def test_signed_window_bits_above_11_raise_on_every_device():
    """Window bits 12 give 2,049 buckets, more than the window-sum kernel's
    shared memory holds: the signed route refuses them on the CPU too, before
    any work; 11 stays the largest it takes."""
    pts = [ech.g1_mul(ech.G1, k) for k in (1, 2, 3)]
    px, py, pinf = tb.pack_affine(pts, "cpu")
    sd = f.pack_ints([5, 6, 7], "cpu")
    assert (1 << (11 - 1)) + 1 <= pk.WINDOW_MAX_BUCKETS < (1 << (12 - 1)) + 1
    with pytest.raises(ValueError, match="shared memory"):
        pip.msm_packed(px, py, pinf, sd, window_bits=12, signed=True)
    assert pip.msm_packed(px, py, pinf, sd, window_bits=4, signed=True) == ech.g1_mul(ech.G1, 5 + 12 + 21)


def _lane_table(n: int, seed: int):
    """A small bucket loop: 2 windows of n points, keys in [0, 4), 2 subs per
    bucket, lanes sorted by need, and some lanes with an empty run."""
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 4, (2, n)))
    sk, order = torch.sort(keys, dim=1, stable=True)
    seg = torch.searchsorted(sk, torch.arange(4).expand(2, 4).contiguous())
    cnt = torch.searchsorted(sk, torch.arange(4).expand(2, 4).contiguous(), right=True) - seg
    win = torch.arange(2).repeat_interleave(8)
    bkt = torch.arange(4).repeat_interleave(2).repeat(2)
    sub = torch.arange(2).repeat(8)
    nsub = torch.full((16,), 2)
    seg_l, cnt_l = seg[win, bkt], cnt[win, bkt]
    cnt_l[bkt == 0] = 0  # bucket 0: empty runs
    need = lp._need(cnt_l, sub, nsub)
    perm = torch.argsort(need, descending=True, stable=True)
    table = tuple(x[perm].to(torch.int32) for x in (seg_l, cnt_l, sub, nsub, win))
    return order.reshape(-1).to(torch.int32), table, perm.to(torch.int32), need


def test_bucket_loop_plain_equals_stepwise_k5():
    """The plain loop equals K5's plain step applied lane by lane, each lane's
    points in run order, placed at the lane's unsorted column."""
    n = 12
    prng = random.Random(4)
    pts = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(n)]
    px, py, _ = tb.pack_affine(pts, "cpu")
    packed = tb.pack_points_dense(px, py)
    order, table, lane, need = _lane_table(n, 5)
    neg = torch.from_numpy(np.random.default_rng(6).random(2 * n) < 0.5)
    out = lp.bucket_loop_lazy(packed, order, neg, *table, lane, n)
    seg, cnt, sub, nsub, win = (t.tolist() for t in table)
    assert int(need.max()) >= 2 and int((need == 0).sum()) >= 4
    for i in range(len(seg)):
        acc = lp.inf_acc(1, "cpu")
        for j in range(sub[i], cnt[i], nsub[i]):
            at = win[i] * n + seg[i] + j
            acc = lp.padd_mixed_packed_lazy_plain(
                *acc, packed[order[at].long()][None], torch.tensor([False]), neg[at][None])
        col = int(lane[i])
        assert all(torch.equal(o[:, col], a[:, 0]) for o, a in zip(out, acc))


def test_loop_wrappers_raise_on_inputs_they_do_not_take():
    n = 12
    packed = torch.zeros((n, 16), dtype=torch.int32)
    order, table, lane, _ = _lane_table(n, 7)
    neg = torch.zeros(2 * n, dtype=torch.bool)
    before = (dict(lp.LAUNCHES), dict(pk.LAUNCHES))
    lp.bucket_loop_lazy(packed, order, neg, *table, lane, n)
    with pytest.raises(ValueError):
        lp.bucket_loop_lazy(packed, order.to(torch.int64), neg, *table, lane, n)
    with pytest.raises(ValueError):
        lp.bucket_loop_lazy(packed, order, neg[:-1], *table, lane, n)
    with pytest.raises(ValueError):
        lp.bucket_loop_lazy(packed[:-1], order, neg, *table, lane, n)
    with pytest.raises(ValueError):
        lp.bucket_loop_lazy(packed, order, neg, *table[:4], table[4][:-1], lane, n)
    with pytest.raises(ValueError, match="sorted"):  # the rounds need lanes sorted by need
        lp.bucket_loop_lazy(packed, order, neg, *(t.flip(0) for t in table), lane.flip(0), n)
    b = tuple(torch.zeros((8, 2, 5), dtype=torch.int32) for _ in range(3))
    pk.window_sums(*b)
    with pytest.raises(TypeError):
        pk.window_sums(b[0], b[1], b[2].to(torch.int64))
    with pytest.raises(ValueError):
        pk.window_sums(b[0], b[1], b[2][:, :, :4])
    with pytest.raises(ValueError):
        pk.window_sums(*(c.reshape(8, 10) for c in b))
    with pytest.raises(ValueError):
        pk.window_sums(b[0], b[1], b[2].transpose(1, 2).contiguous().transpose(1, 2))
    assert (dict(lp.LAUNCHES), dict(pk.LAUNCHES)) == before  # no kernel on the CPU
