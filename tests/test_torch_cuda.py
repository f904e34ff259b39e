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
from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
from paillier_halo2_tpu_torch.plonk.srs import generate_srs

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
    counts = (mulmod.LAUNCHES["mont_mul"], pk.LAUNCHES["g1_jadd"], pk.LAUNCHES["g1_madd_packed"])
    got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, f.pack_ints(scalars, dev), signed=False)
    ex, ey = json.loads((ROOT / "params_fixtures" / "bench_msm_expected_10.json").read_text())
    assert got == (int(ex, 16), int(ey, 16))
    after = (mulmod.LAUNCHES["mont_mul"], pk.LAUNCHES["g1_jadd"], pk.LAUNCHES["g1_madd_packed"])
    assert all(b > a for a, b in zip(counts, after))


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
    assert lp.LAUNCHES == {k: v + 1 for k, v in before.items()}
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
    before = dict(lp.LAUNCHES)
    got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, f.pack_ints(scalars, dev))  # signed: card
    ex, ey = json.loads((ROOT / "params_fixtures" / "bench_msm_expected_10.json").read_text())
    assert got == (int(ex, 16), int(ey, 16))
    assert all(lp.LAUNCHES[k] > before[k] for k in before)
