"""The PyTorch port's CUDA kernels on the card: each against its plain
PyTorch version on the same device tensors, exactly, with edge lanes, and
each wrapper's launch count and input checks.

These tests need a CUDA device and nvcc; without them they skip. The file
imports no JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -q
"""
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from paillier_halo2_tpu_torch.ec import bn254
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ec import lazy_point as lp
from paillier_halo2_tpu_torch.ec import point_kernels as pk
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import lazy_mont as lz
from paillier_halo2_tpu_torch.ff import mulmod
from paillier_halo2_tpu_torch.bignum.host import paillier_enc_native
from paillier_halo2_tpu_torch.gadgets.context import Context, VirtualTable
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
from paillier_halo2_tpu_torch.mock import prover as mock
from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
from paillier_halo2_tpu_torch.plonk.keygen import FIXED_CELLS, keygen
from paillier_halo2_tpu_torch.plonk.prover import create_proof
from paillier_halo2_tpu_torch.plonk.serialize import (
    load_proving_key,
    save_proving_key,
    table_fingerprint,
)
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
Q, RM = ech.Q, (1 << 256) % ech.Q


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda", 0)


def _values(p: int, seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [int.from_bytes(w.astype(np.uint32).tobytes(), "little") % p for w in words]
    edge = [0, 1, p - 1, p - 2, (1 << 256) % p]
    vals[: len(edge)] = edge
    return vals


@pytest.mark.parametrize("spec", [f.FR, f.FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("lanes", [1, 1000, 1 << 16])
def test_mont_mul_kernel_matches_plain(dev, spec, lanes):
    xs = _values(spec.p, 1, lanes)
    ys = _values(spec.p, 2, lanes)[::-1]
    a, b = f.pack_ints(xs, dev), f.pack_ints(ys, dev)
    before = mulmod.LAUNCHES["mont_mul"]
    out = mulmod.mont_mul(spec, a, b)
    torch.cuda.synchronize()
    assert mulmod.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(out, mulmod.mont_mul_plain(spec, a, b))
    rinv = pow(1 << 256, -1, spec.p)
    assert f.unpack_ints(out[:, :16]) == [x * y * rinv % spec.p for x, y in zip(xs[:16], ys[:16])]


def _addsub_edges(p: int) -> list[tuple[int, int]]:
    """Edge lanes of add and sub: 0, 1, p - 1, a + b = p, a + b = p - 1,
    a = b and b = 0, each way round."""
    x = 0x1234567890ABCDEF1234567890ABCDEF % p
    pairs = [(0, 0), (0, 1), (1, 0), (0, p - 1), (p - 1, 0), (1, p - 1), (p - 1, 1),
             (p - 1, p - 1), (x, p - x), (p - x, x), (x, p - 1 - x), (p - 1 - x, x), (x, x),
             (x, 0), (0, x), (1, 1)]
    return pairs


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("spec", [f.FR, f.FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("lanes", [1, 255, 1 << 16, (1 << 16) + 3])
def test_add_sub_kernel_matches_plain(dev, op, spec, lanes):
    xs = _values(spec.p, 11, lanes)
    ys = _values(spec.p, 12, lanes)[::-1]
    for i, (u, v) in enumerate(_addsub_edges(spec.p)[:lanes]):
        xs[i], ys[i] = u, v
    a, b = f.pack_ints(xs, dev), f.pack_ints(ys, dev)
    before = dict(f.LAUNCHES)
    out = getattr(f, op)(spec, a, b)
    torch.cuda.synchronize()
    assert f.LAUNCHES[op] == before[op] + 1 and f.LAUNCHES["copied"] == before["copied"]
    assert out.shape == a.shape and out.dtype == torch.int32 and out.is_contiguous()
    assert torch.equal(out, getattr(f, op + "_plain")(spec, a, b))
    sign = 1 if op == "add" else -1
    assert f.unpack_ints(out[:, :64]) == [(x + sign * y) % spec.p for x, y in zip(xs[:64], ys[:64])]


def _addsub_views(dev):
    """(a, b) of the callers' shapes: the prover's slabs against a challenge,
    either way round; the NTT's strided u at a wide and at the first stage;
    narrowed halves (`sum_axis`); neg's p expanded."""
    g, n = 7, 1 << 12
    vals = f.pack_ints(_values(f.FR.p, 13, g * n), dev)
    slab = vals.reshape(8, g, n)
    chal = vals[:, :n].reshape(8, 1, n).flip(-1).contiguous()
    x = vals[:, : 1 << 14]
    v = f.pack_ints(_values(f.FR.p, 14, 1 << 13), dev)
    return {
        "slab_plus_challenge": (slab, chal),
        "challenge_plus_slab": (chal, slab),
        "ntt_strided_view": (x.reshape(8, 16, 2, 512)[..., 0, :], v.reshape(8, 16, 512)),
        "ntt_first_stage": (x.reshape(8, 1 << 13, 2, 1)[..., 0, :], v.reshape(8, 1 << 13, 1)),
        "narrowed_halves": (slab.narrow(1, 0, 3), slab.narrow(1, 3, 3)),
        "neg_p_expanded": (f.FR.limbs("p", dev).reshape(8, 1, 1).expand(8, g, n), slab),
    }


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("case", ["slab_plus_challenge", "challenge_plus_slab", "ntt_strided_view",
                                  "ntt_first_stage", "narrowed_halves", "neg_p_expanded"])
def test_add_sub_kernel_reads_views_in_place(dev, op, case):
    """The kernel reads broadcast, strided and narrowed operands where they
    lie: one launch, no copy, the plain version's bits."""
    a, b = _addsub_views(dev)[case]
    before = dict(f.LAUNCHES)
    out = getattr(f, op)(f.FR, a, b)
    torch.cuda.synchronize()
    assert f.LAUNCHES[op] == before[op] + 1 and f.LAUNCHES["copied"] == before["copied"]
    ref = getattr(f, op + "_plain")(f.FR, a, b)
    assert out.shape == ref.shape and out.is_contiguous() and torch.equal(out, ref)


def test_add_sub_kernel_copies_past_four_dimensions_and_skips_empty_calls(dev):
    five = f.pack_ints(_values(f.FQ.p, 15, 2 * 3 * 2 * 3 * 2), dev).reshape(8, 2, 3, 2, 3, 2)
    a, b = five.permute(0, 5, 4, 3, 2, 1), five[:, :1].permute(0, 5, 4, 3, 2, 1)
    before = dict(f.LAUNCHES)
    out = f.sub(f.FQ, a, b)
    torch.cuda.synchronize()
    assert f.LAUNCHES["sub"] == before["sub"] + 1 and f.LAUNCHES["copied"] == before["copied"] + 2
    assert torch.equal(out, f.sub_plain(f.FQ, a, b))
    empty = f.add(f.FQ, five[:, :0], five[:, :0])
    assert empty.shape == (8, 0, 3, 2, 3, 2) and f.LAUNCHES["add"] == before["add"]
    with pytest.raises(TypeError):
        f.add(f.FQ, five.to(torch.int64), five.to(torch.int64))
    with pytest.raises(ValueError):
        f.add(f.FQ, five, five.cpu())
    with pytest.raises(ValueError):
        f.add(f.FQ, five[:4], five[:4])


@pytest.fixture(scope="module")
def point_operands(dev):
    """4096 lanes of (P, Q) for each point kernel, edge lanes first: P+inf,
    inf+Q, P+P, P+(-P), inf+inf; and the host sums of the first 64 lanes."""
    n = 4096
    prng = random.Random(3)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(32)]
    ps, qs = [], []
    while len(ps) < n:
        p, q = prng.choice(pool), prng.choice(pool)
        if q not in (p, ech.g1_neg(p)):
            ps.append(p)
            qs.append(q)
    p0 = pool[0]
    edges = [(p0, None), (None, p0), (p0, p0), (p0, ech.g1_neg(p0)), (None, None)]
    for i, (p, q) in enumerate(edges):
        ps[i], qs[i] = p, q
    cols = ([], [], [])
    for p in ps:  # Jacobian with random Z; infinity as (0, 0, 0)
        z = prng.randrange(1, Q) if p is not None else 0
        vals = (0, 0, 0) if p is None else (p[0] * z * z % Q, p[1] * z * z * z % Q, z)
        for c, v in zip(cols, vals):
            c.append(v * RM % Q)
    P = tuple(f.pack_ints(c, dev) for c in cols)
    Qj = bn254.pack_jacobian(qs, dev)
    qx, qy, qinf = bn254.pack_affine(qs, dev)
    return {
        "g1_jadd": (*P, *Qj),
        "g1_madd": (*P, qx, qy, qinf),
        "g1_madd_packed": (*P, bn254.pack_points_dense(qx, qy), qinf),
    }, [ech.g1_add(p, q) for p, q in zip(ps[:64], qs[:64])]


@pytest.mark.parametrize("name", ["g1_jadd", "g1_madd", "g1_madd_packed"])
@pytest.mark.parametrize("nodouble", [False, True])
def test_point_kernels_match_plain(point_operands, name, nodouble):
    operands, want = point_operands
    args, want = operands[name], list(want)
    before = pk.LAUNCHES[name]
    out = getattr(pk, name)(*args, nodouble=nodouble)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[name] == before + 1
    ref = getattr(pk, name + "_plain")(*args, nodouble=nodouble)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    got = bn254.unpack_jacobian(tuple(c[:, :64] for c in out))
    if nodouble:  # P+P and P+(-P) break the contract and degrade to infinity
        assert got[2] is None and got[3] is None
        got[2:4], want[2:4] = [], []
    assert got == want


def test_wrappers_raise_on_card_inputs_they_do_not_take(dev):
    a = f.pack_ints(_values(f.FR.p, 4, 64), dev)
    with pytest.raises(TypeError):
        mulmod.mont_mul(f.FR, a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        mulmod.mont_mul(f.FR, a, a.cpu())
    P = (a, a, a)
    with pytest.raises(ValueError):
        pk.g1_madd(*P, a, a, torch.zeros(64, dtype=torch.int32, device=dev))


def test_msm_2e10_on_card_matches_fixture(dev):
    srs = generate_srs(10, b"", dev)
    rng = np.random.default_rng(1)  # bench.py's MSM scalar stream
    hi = rng.integers(0, 2**63, (4, 1 << 10), dtype=np.int64)
    scalars = [(int(x) | int(y) << 63 | int(z) << 126 | int(w) << 189) % ech.R
               for x, y, z, w in zip(*hi)]
    before = {**mulmod.LAUNCHES, **pk.LAUNCHES}
    got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, f.pack_ints(scalars, dev), signed=False)
    ex, ey = json.loads((ROOT / "params_fixtures" / "bench_msm_expected_10.json").read_text())
    assert got == (int(ex, 16), int(ey, 16))
    after = {**mulmod.LAUNCHES, **pk.LAUNCHES}
    # the bucket loop in one launch, no K4 step; K2 levels in the merge
    assert after["bucket_loop"] == before["bucket_loop"] + 1
    assert after["g1_madd_packed"] == before["g1_madd_packed"]
    assert after["g1_jadd"] > before["g1_jadd"] and after["mont_mul"] > before["mont_mul"]


@pytest.mark.parametrize("spec", [f.FR, f.FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("lanes", [1, 1000, 1 << 16])
def test_mont_mul_lazy_kernel_matches_plain(dev, spec, lanes):
    """K7 on values in [0, 2p), edges 0, 1, p - 1, p, 2p - 1 first."""
    p = spec.p
    xs = [v + p if i % 2 else v for i, v in enumerate(_values(p, 5, lanes))]
    ys = _values(p, 6, lanes)[::-1]
    edge = [0, 1, p - 1, p, 2 * p - 1]
    xs[: len(edge)] = edge[: len(xs)]
    a, b = f.pack_ints(xs, dev), f.pack_ints(ys, dev)
    before = lz.LAUNCHES["mont_mul_lazy"]
    out = lz.mont_mul_lazy(spec, a, b)
    torch.cuda.synchronize()
    assert lz.LAUNCHES["mont_mul_lazy"] == before + 1
    assert torch.equal(out, lz.mont_mul_lazy_plain(spec, a, b))
    assert torch.equal(lz.canonicalize(spec, out), mulmod.mont_mul(spec, a, b))


def test_lazy_point_kernels_match_plain(dev, point_operands):
    """K5 and K6 on the point kernels' operands, with a random half of the
    lanes negated (K5) and the accumulators' coordinates put in [p, 2p) on
    alternate lanes; canonicalised, K5 with neg unset equals K4 nodouble."""
    operands, _ = point_operands
    X1, Y1, Z1, X2, Y2, Z2 = operands["g1_jadd"]
    packed, qinf = operands["g1_madd_packed"][3:]
    n = X1.shape[1]
    z = f.unpack_ints(Z1)

    def bump(c):  # c + p on alternate finite lanes: the same values mod p
        vals = f.unpack_ints(c)
        return f.pack_ints([v + f.FQ.p if i % 2 and z[i] else v for i, v in enumerate(vals)], dev)

    acc = tuple(bump(c) for c in (X1, Y1, Z1))
    neg = torch.rand(n, device=dev) < 0.5
    before = dict(lp.LAUNCHES)
    out = lp.padd_mixed_packed_lazy(*acc, packed, qinf, neg)
    torch.cuda.synchronize()
    assert all(torch.equal(o, r) for o, r in
               zip(out, lp.padd_mixed_packed_lazy_plain(*acc, packed, qinf, neg)))
    out = lp.padd_lazy(acc, (X2, Y2, Z2))
    torch.cuda.synchronize()
    assert all(torch.equal(o, r) for o, r in zip(out, lp.padd_lazy_plain(*acc, X2, Y2, Z2)))
    assert lp.LAUNCHES == {k: v + (k in ("padd_mixed_packed_lazy", "padd_lazy"))
                           for k, v in before.items()}
    no_neg = torch.zeros_like(neg)
    lazy = lp.canonicalize_jp(*lp.padd_mixed_packed_lazy(X1, Y1, Z1, packed, qinf, no_neg))
    k4 = pk.g1_madd_packed(X1, Y1, Z1, packed, qinf, nodouble=True)
    assert all(torch.equal(a, b) for a, b in zip(lazy, k4))


def test_signed_msm_2e10_on_card_matches_fixture(dev):
    srs = generate_srs(10, b"", dev)
    rng = np.random.default_rng(1)  # bench.py's MSM scalar stream
    hi = rng.integers(0, 2**63, (4, 1 << 10), dtype=np.int64)
    scalars = [(int(x) | int(y) << 63 | int(z) << 126 | int(w) << 189) % ech.R
               for x, y, z, w in zip(*hi)]
    before = {**lp.LAUNCHES, **pk.LAUNCHES}
    got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, f.pack_ints(scalars, dev))  # signed: card
    ex, ey = json.loads((ROOT / "params_fixtures" / "bench_msm_expected_10.json").read_text())
    assert got == (int(ex, 16), int(ey, 16))
    after = {**lp.LAUNCHES, **pk.LAUNCHES}
    # one launch of each loop kernel and of the merge, and no K5, K6 or K2 step
    assert after["bucket_loop_lazy"] == before["bucket_loop_lazy"] + 1
    assert after["window_sums"] == before["window_sums"] + 1
    assert after["merge_lazy"] == before["merge_lazy"] + 1
    assert after["padd_lazy"] == before["padd_lazy"]
    assert after["padd_mixed_packed_lazy"] == before["padd_mixed_packed_lazy"]
    assert after["g1_jadd"] == before["g1_jadd"]


def _window_buckets(n_buckets: int, rows: int, seed: int, dev):
    """(8, rows, n_buckets) Jacobian buckets with random Z from a pool of
    points; row 0 holds infinities (both encodings), equal neighbours and a
    P / -P pair of neighbours."""
    prng = random.Random(seed)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(64)]
    pts = [prng.choice(pool) for _ in range(rows * n_buckets)]
    pts[0], pts[2] = None, None
    pts[6] = pts[5]
    pts[4] = ech.g1_neg(pts[3])
    cols = ([], [], [])
    for i, p in enumerate(pts):
        z = prng.randrange(1, Q) if p is not None else 0
        vals = ((1, 1, 0) if i == 2 else (0, 0, 0)) if p is None else (
            p[0] * z * z % Q, p[1] * z * z * z % Q, z)
        for c, v in zip(cols, vals):
            c.append(v * RM % Q)
    return tuple(f.pack_ints(c, dev).reshape(8, rows, n_buckets) for c in cols)


@pytest.mark.parametrize("n_buckets,rows", [(9, 5), (129, 3), (1025, 2)])
def test_window_sums_kernel_matches_plain(dev, n_buckets, rows):
    """B = 1,025 needs the shared-memory opt-in (196,800 B a block)."""
    b = _window_buckets(n_buckets, rows, n_buckets, dev)
    before = pk.LAUNCHES["window_sums"]
    out = pk.window_sums(*b)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["window_sums"] == before + 1
    assert all(torch.equal(o, r) for o, r in zip(out, pk.window_sums_plain(*b)))
    too_many = tuple(torch.zeros((8, 1, pk.WINDOW_MAX_BUCKETS + 1), dtype=torch.int32, device=dev)
                     for _ in range(3))
    with pytest.raises(ValueError):
        pk.window_sums(*too_many)


def _loop_inputs(n: int, n_windows: int, n_buckets: int, subs: int, seed: int, dev):
    """A bucket loop over n pool points: keys in [0, n_buckets) per window,
    `subs` sub-accumulators per bucket, bucket 0's runs empty, lanes sorted
    by need; `neg` random."""
    prng = random.Random(seed)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(64)]
    px, py, _ = bn254.pack_affine([prng.choice(pool) for _ in range(n)], dev)
    packed = bn254.pack_points_dense(px, py)
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, n_buckets, (n_windows, n)))
    sk, order = torch.sort(keys, dim=1, stable=True)
    targets = torch.arange(n_buckets).expand(n_windows, n_buckets).contiguous()
    seg = torch.searchsorted(sk, targets)
    cnt = torch.searchsorted(sk, targets, right=True) - seg
    cnt[:, 0] = 0
    win = torch.arange(n_windows).repeat_interleave(n_buckets * subs)
    bkt = torch.arange(n_buckets).repeat_interleave(subs).repeat(n_windows)
    sub = torch.arange(subs).repeat(n_windows * n_buckets)
    nsub = torch.full_like(sub, subs)
    seg_l, cnt_l = seg[win, bkt], cnt[win, bkt]
    perm = torch.argsort(pk._need(cnt_l, sub, nsub), descending=True, stable=True)
    table = tuple(x[perm].to(torch.int32).to(dev) for x in (seg_l, cnt_l, sub, nsub, win))
    neg = torch.from_numpy(rng.random(n_windows * n) < 0.5).to(dev)
    return (packed, order.reshape(-1).to(torch.int32).to(dev), neg, *table,
            perm.to(torch.int32).to(dev), n)


@pytest.mark.parametrize("n,n_windows,n_buckets,subs", [(1000, 3, 17, 4), (4099, 2, 33, 3)])
def test_bucket_loop_kernel_matches_plain(dev, n, n_windows, n_buckets, subs):
    """Lane counts that leave a ragged last block (204 and 198 lanes of
    128-thread blocks), bucket 0's empty runs, and negated points."""
    args = _loop_inputs(n, n_windows, n_buckets, subs, n, dev)
    assert args[3].shape[0] % 128 != 0
    before = dict(lp.LAUNCHES)
    out = lp.bucket_loop_lazy(*args)
    torch.cuda.synchronize()
    assert lp.LAUNCHES["bucket_loop_lazy"] == before["bucket_loop_lazy"] + 1
    assert all(torch.equal(o, r) for o, r in zip(out, lp.bucket_loop_lazy_plain(*args)))
    stepwise = lp.bucket_rounds(lp.padd_mixed_packed_lazy, *args)  # K5 step launches
    assert all(torch.equal(o, r) for o, r in zip(out, stepwise))
    raw = torch.empty(args[0].numel() + 1, dtype=torch.int32, device=dev)
    unaligned = raw[1:].view(args[0].shape)
    unaligned.copy_(args[0])
    with pytest.raises(ValueError, match="aligned"):
        lp.bucket_loop_lazy(unaligned, *args[1:])


@pytest.mark.parametrize("n,n_windows,n_buckets,subs", [(1000, 3, 17, 4), (4099, 2, 33, 3)])
def test_unsigned_bucket_loop_kernel_matches_plain(dev, n, n_windows, n_buckets, subs):
    """The unsigned loop, with a ragged last block and bucket 0's empty
    runs, against its plain version and against the rounds of K4 step
    launches; an unaligned `packed` raises."""
    full = _loop_inputs(n, n_windows, n_buckets, subs, n + 1, dev)
    args = (full[0], full[1], *full[3:])  # no neg
    assert args[2].shape[0] % 128 != 0
    before = dict(pk.LAUNCHES)
    out = pk.bucket_loop(*args)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["bucket_loop"] == before["bucket_loop"] + 1
    assert pk.LAUNCHES["g1_madd_packed"] == before["g1_madd_packed"]
    assert all(torch.equal(o, r) for o, r in zip(out, pk.bucket_loop_plain(*args)))
    stepwise = pk.k4_rounds(pk.g1_madd_packed, *args)  # K4 step launches
    assert pk.LAUNCHES["g1_madd_packed"] > before["g1_madd_packed"]
    assert all(torch.equal(o, r) for o, r in zip(out, stepwise))
    raw = torch.empty(args[0].numel() + 1, dtype=torch.int32, device=dev)
    unaligned = raw[1:].view(args[0].shape)
    unaligned.copy_(args[0])
    with pytest.raises(ValueError, match="aligned"):
        pk.bucket_loop(unaligned, *args[1:])


def _comb_table(dev):
    from paillier_halo2_tpu_torch.plonk.srs import _comb_table as host_table

    px, py, pinf = bn254.pack_affine([p for row in host_table() for p in row], dev)
    return bn254.pack_points_dense(px, py), pinf


@pytest.mark.parametrize("lanes", [1, 1000, 1 << 14])
def test_fixed_base_comb_kernel_matches_plain(dev, lanes):
    """The SRS comb on random scalars below r, with 0, 1, r - 1, equal
    scalars, and r and 49 * 2^249 - r, which reach the annihilation and the
    doubling branches, first."""
    table, inf = _comb_table(dev)
    rng = np.random.default_rng(lanes)
    scalars = [int.from_bytes(rng.bytes(32), "little") % ech.R for _ in range(lanes)]
    edge = [0, 1, ech.R - 1, ech.R, 49 * (1 << 249) - ech.R, scalars[-1]]
    scalars[: len(edge)] = edge[:lanes]
    sd = f.pack_ints(scalars, dev)
    before = pk.LAUNCHES["fixed_base_comb"]
    out = pk.fixed_base_comb(table, inf, sd)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["fixed_base_comb"] == before + 1
    assert all(torch.equal(o, r) for o, r in zip(out, pk.fixed_base_comb_plain(table, inf, sd)))
    got = bn254.unpack_jacobian(tuple(c[:, :16] for c in out))
    assert got == [ech.g1_mul(ech.G1, s % ech.R) for s in scalars[:16]]
    with pytest.raises(ValueError, match="aligned"):
        raw = torch.empty(table.numel() + 1, dtype=torch.int32, device=dev)
        unaligned = raw[1:].view(table.shape)
        unaligned.copy_(table)
        pk.fixed_base_comb(unaligned, inf, sd)


MERGE_LAYOUTS = {
    # (s, bcap, rows), n_buckets: groups of 1, 4, 32 threads and a CTA a
    # bucket (s = 128, 4096), capped windows, rows out of order
    "mixed": ([(8, 33, [0, 2, 1]), (4096, 4, [3]), (1, 5, [4]), (2, 33, [5]), (64, 7, [6]),
               (128, 3, [7])], 33),
    # the 2^14 MSM's layout at c = 8: s = 8 for 31 windows, s = 32 for the top one
    "k14": ([(8, 129, list(range(31))), (32, 51, [31])], 129),
}


@pytest.mark.parametrize("layout", sorted(MERGE_LAYOUTS))
def test_merge_kernel_matches_plain(dev, layout):
    """The merge on redundant-form accumulators (random values in [0, 2p),
    every seventh lane at infinity, in both encodings)."""
    blocks, nb = MERGE_LAYOUTS[layout]
    n_lanes = sum(s * bc * len(r) for s, bc, r in blocks)
    rng = np.random.default_rng(n_lanes)
    acc = []
    for c in range(3):
        words = rng.integers(0, 1 << 32, size=(n_lanes, 8), dtype=np.uint64)
        vals = [int.from_bytes(w.astype(np.uint32).tobytes(), "little") % (2 * Q) for w in words]
        for i in range(3, n_lanes, 7):
            vals[i] = (RM if i % 14 == 3 else 0) if c < 2 else 0
        acc.append(f.pack_ints(vals, dev))
    acc = tuple(acc)
    before = dict(lp.LAUNCHES)
    out = lp.merge_lazy(acc, blocks, nb)
    torch.cuda.synchronize()
    assert lp.LAUNCHES["merge_lazy"] == before["merge_lazy"] + 1
    assert lp.LAUNCHES["padd_lazy"] == before["padd_lazy"]
    ref = lp.merge_lazy_plain(acc, blocks, nb)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    stepwise = lp.canonicalize_jp(*lp.merge_rounds(lp.padd_lazy, acc, blocks, nb))  # K6 launches
    assert all(torch.equal(o, r) for o, r in zip(out, stepwise))


@pytest.mark.parametrize("route", ["one-shot", "chunked"])
def test_mock_prove_on_card_matches_host(dev, route):
    """The MockProver on the card (K1 for the gate products) against the
    host oracle on a tampered ENC 32 / LIMB 16 table: the three overlap
    rows after the first 2^10-row chunk, the next chunk's first row, a
    gate, a copy, a constant and a lookup out of range."""
    prng = random.Random(99)
    n = prng.getrandbits(32) | 1
    g, m, r = (prng.getrandbits(32) for _ in range(3))
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, 10),
                      PaillierEncryptionInput(32, 16, n, g, m, r, paillier_enc_native(n, g, m, r)))
    t = ctx.finalize()
    vals = t.values.copy()
    chunk = 1 << 10
    for row in (chunk, chunk + 1, chunk + 2, 2 * chunk, int(t.gates[7]) + 3, int(t.copy_b[5]),
                int(t.const_idx[0])):
        vals[row] = (int(vals[row]) + 1) % f.FR.p
    vals[int(t.lookups[3])] = 1 << 10
    t = VirtualTable(vals, t.gates, t.copy_a, t.copy_b, t.const_idx, t.const_val, t.lookups)
    before = mulmod.LAUNCHES["mont_mul"]
    if route == "one-shot":
        stats = {}
        got = mock.mock_prove_torch(t, 10, device=dev, stats=stats)
        assert stats["route"] == "one-shot"
    else:
        got = mock.mock_prove_chunked(t, 10, chunk_rows=chunk, device=dev)
    assert mulmod.LAUNCHES["mont_mul"] > before
    want = mock.mock_prove_host(t, 10)
    assert not want.satisfied and got.satisfied == want.satisfied
    for name in ("gate_failures", "lookup_failures", "copy_failures", "const_failures"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def _k10_table(fx):
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"], **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    return ctx.finalize()


@pytest.mark.parametrize("fixture,multiopen", [("slice_enc_k10.json", "shplonk"),
                                               ("slice_enc_k10_gwc.json", "gwc")])
def test_k10_proof_on_card_from_a_loaded_key_matches_fixture(dev, tmp_path, fixture, multiopen):
    """keygen on the card, save, load back onto the card under the
    fingerprint, prove with the loaded key: the proof equals the JAX
    package's fixture for the scheme, and verifies."""
    fx = json.loads((ROOT / "tests" / "torch_fixtures" / fixture).read_text())
    table = _k10_table(fx)
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), dev)
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs, multiopen=multiopen)
    fp = table_fingerprint(table, fx["k"], fx["lookup_bits"], multiopen)
    path = str(tmp_path / "pk.npz")
    save_proving_key(pk, path, table_fp=fp)
    pk2 = load_proving_key(path, srs, expect_table_fp=fp)
    assert pk2.q_coeffs[0].device.type == "cuda" and pk2.vk.multiopen == multiopen
    proof = create_proof(pk2, table, fx["blinding_seed"].encode())
    assert proof.hex() == fx["proof_hex"]
    assert verify_proof(pk.vk, srs, proof)


def test_k10_keygen_on_card_equals_keygen_on_the_cpu(dev):
    """The fixed columns formed on the card (sigma gathered from the device
    power tables, the small columns from integer arrays): every coefficient
    and every verifying-key commitment equals the CPU key's bit for bit, and
    both keygens count the same cells."""
    fx = json.loads((ROOT / "tests" / "torch_fixtures" / "slice_enc_k10.json").read_text())
    table = _k10_table(fx)
    keys, cells = [], []
    for d in ("cpu", dev):
        srs = generate_srs(fx["k"], fx["srs_seed"].encode(), d)
        before = dict(FIXED_CELLS)
        keys.append(keygen(table, fx["k"], fx["lookup_bits"], srs))
        cells.append({key: FIXED_CELLS[key] - before[key] for key in before})
    cpu, card = keys
    assert card.q_coeffs[0].device.type == "cuda"
    names = ("q", "fixed_const", "table", "sigma", "active", "l0", "lu")
    for name in names:
        want, got = getattr(cpu, name + "_coeffs"), getattr(card, name + "_coeffs")
        if isinstance(want, list):
            want, got = torch.stack(want), torch.stack(got)
        assert torch.equal(got.cpu(), want), name
    assert card.vk.fixed_commitments() == cpu.vk.fixed_commitments()
    n = 1 << fx["k"]
    assert cells[0] == cells[1] == {"device": (cpu.vk.num_advice + 4 + cpu.vk.n_perm_cols) * n,
                                    "host_ints": n}


def test_native_ntt_backend_refuses_a_card_tensor(dev):
    """A transform on the card never goes to the host: the default route
    takes the port's NTT, and "native" raises."""
    from paillier_halo2_tpu_torch.poly import ops
    from paillier_halo2_tpu_torch.poly.ntt import ntt

    k = 4
    x = f.pack_ints(_values(ech.R, 31, 1 << k), dev)
    ops.reset_ntt_routes()
    assert torch.equal(ops.values_of(x, k), ntt(x, k))
    assert ops.NTT_ROUTES == {"mesh": 0, "native": 0, "torch": 1}
    with ops.ntt_backend("native"), pytest.raises(ValueError, match="runs on the host"):
        ops.values_of(x, k)


@pytest.mark.parametrize("fixture,multiopen", [("slice_enc_k10.json", "shplonk"),
                                               ("slice_enc_k10_gwc.json", "gwc")])
def test_k10_proof_on_card_with_every_check_matches_fixture(dev, capsys, fixture, multiopen):
    """checks="all" on the card: every self-check passes, the proof equals
    the JAX package's fixture and verifies (a GWC proof's openings one by
    one too)."""
    fx = json.loads((ROOT / "tests" / "torch_fixtures" / fixture).read_text())
    table = _k10_table(fx)
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), dev)
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs, multiopen=multiopen)
    proof = create_proof(pk, table, fx["blinding_seed"].encode(), checks="all")
    assert proof.hex() == fx["proof_hex"]
    assert verify_proof(pk.vk, srs, proof, selfcheck=True)
    out = capsys.readouterr().out
    assert "[selfcheck] t degree tail: 0/" in out and "FAILS" not in out
