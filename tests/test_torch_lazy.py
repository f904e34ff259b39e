"""The PyTorch port's redundant-form arithmetic (`ff/lazy_mont.py`, K7) and
lazy point adds (`ec/lazy_point.py`, K5 and K6) against the JAX package's XLA
functions `lazy_mont.lmul`, `lazy_point._mixed_add_lazy` and
`lazy_point._jacobian_add_lazy` (not its Pallas kernels), run on the CPU.

The two packages hold lazy values differently (signed base-256 digits there,
[0, 2p) limbs here), so results are compared after each side's
canonicalisation: the formulas are the same, so X, Y and Z agree mod p. The
port's inputs are put in [p, 2p) on a random half of the lanes; the JAX
package gets the same values canonical. Edge lanes come first. The kernels
themselves are held against these plain versions on the card in
`test_torch_cuda.py`.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ec import bn254 as jb
from paillier_halo2_tpu.ec import lazy_point as jlp
from paillier_halo2_tpu.ff import lazy_mont as jlz
from paillier_halo2_tpu_torch.ec import bn254 as tb
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ec import lazy_point as lp
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import lazy_mont as lz

LANES = 64
Q = ech.Q
RM = (1 << 256) % Q
QPLAN = jlz.get_lazy_plan(Q)
PT_CONSTS = QPLAN.consts() + (jnp.asarray(QPLAN.one_dig),)


def _values(p: int, seed: int, n: int = LANES) -> list[int]:
    """Random values in [0, 2p), edges first: 0, 1, p - 1, p, 2p - 1."""
    prng = random.Random(seed)
    vals = [prng.randrange(2 * p) for _ in range(n)]
    vals[:5] = [0, 1, p - 1, p, 2 * p - 1]
    return vals


def _redundant(vals: list[int], p: int, seed: int) -> list[int]:
    """The same values mod p, p added to the nonzero ones on a random half."""
    prng = random.Random(seed)
    return [v + p if v and prng.random() < 0.5 else v for v in vals]


def _jacobian_ints(points, seed: int, one_inf: bool = False):
    """Montgomery (X, Y, Z) int lists with random Z; infinity is (0, 0, 0),
    or (one, one, 0) with `one_inf`."""
    prng = random.Random(seed)
    cols = ([], [], [])
    for p in points:
        if p is None:
            vals = (RM, RM, 0) if one_inf else (0, 0, 0)
        else:
            z = prng.randrange(1, Q)
            vals = (p[0] * z * z % Q * RM % Q, p[1] * z ** 3 % Q * RM % Q, z * RM % Q)
        for c, v in zip(cols, vals):
            c.append(v)
    return cols


def _jax_acc(cols):
    """Canonical Montgomery ints -> the JAX package's lazy accumulator LVs."""
    return tuple(jlp._wrap_acc(jnp.asarray(f.to_ref_digits(f.pack_ints(c, "cpu")))
                               .astype(jnp.int32).astype(jnp.int16)) for c in cols)


def _jax_canonical(out_lvs) -> list[np.ndarray]:
    return [np.asarray(c) for c in jlp.canonicalize_jp(jb.SPEC, *(jlp._store(c) for c in out_lvs))]


def _port_canonical(out) -> list[np.ndarray]:
    return [f.to_ref_digits(c) for c in lp.canonicalize_jp(*out)]


# -- K7 and the redundant form -------------------------------------------------------


@pytest.mark.parametrize("spec", [f.FR, f.FQ], ids=["Fr", "Fq"])
def test_mont_mul_lazy_matches_lmul(spec):
    """Canonical values, values in [p, 2p) and the edges, both packages
    canonicalised; the port's output stays below 2p."""
    xs, ys = _values(spec.p, 1), _values(spec.p, 2)[::-1]
    a, b = f.pack_ints(xs, "cpu"), f.pack_ints(ys, "cpu")
    out = lz.mont_mul_lazy(spec, a, b)
    assert max(f.unpack_ints(out)) < 2 * spec.p
    plan = jlz.get_lazy_plan(spec.p)
    ja, jbv = (jlz.to_lazy(jnp.asarray(f.to_ref_digits(t))) for t in (a, b))
    want = np.asarray(jlz.canonicalize(plan, jlz.lmul(plan.consts(), ja, jbv)))
    assert np.array_equal(f.to_ref_digits(lz.canonicalize(spec, out)), want)
    rinv = pow(1 << 256, -1, spec.p)
    assert [v % spec.p for v in f.unpack_ints(out)] == [x * y * rinv % spec.p for x, y in zip(xs, ys)]


def test_mont_mul_lazy_chain_stays_below_2p():
    spec = f.FR
    xs, ys = _values(spec.p, 3), _values(spec.p, 4)
    r, b = f.pack_ints(xs, "cpu"), f.pack_ints(ys, "cpu")
    want = xs
    rinv = pow(1 << 256, -1, spec.p)
    for _ in range(10):
        r = lz.mont_mul_lazy(spec, r, b)
        want = [x * y * rinv % spec.p for x, y in zip(want, ys)]
        assert max(f.unpack_ints(r)) < 2 * spec.p
    assert f.unpack_ints(lz.canonicalize(spec, r)) == want


@pytest.mark.parametrize("spec", [f.FR, f.FQ], ids=["Fr", "Fq"])
def test_redundant_add_sub_canonicalize(spec):
    p = spec.p
    xs, ys = _values(p, 5), _values(p, 6)
    a, b = f.pack_ints(xs, "cpu"), f.pack_ints(ys, "cpu")
    s, d = f.unpack_ints(lz.add_lazy(spec, a, b)), f.unpack_ints(lz.sub_lazy(spec, a, b))
    assert all(v < 2 * p for v in s + d)
    assert [v % p for v in s] == [(x + y) % p for x, y in zip(xs, ys)]
    assert [v % p for v in d] == [(x - y) % p for x, y in zip(xs, ys)]
    assert f.unpack_ints(lz.canonicalize(spec, a)) == [x % p for x in xs]
    zero = f.pack_ints([0], "cpu")
    assert f.unpack_ints(lz.mont_mul_lazy(spec, zero, f.pack_ints([2 * p - 1], "cpu"))) == [0]
    assert f.unpack_ints(lz.sub_lazy(spec, zero, zero)) == [0]


# -- K5 and K6 ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k5_lanes():
    """Accumulator P, operand Q, mask_off, neg. Edge lanes: P at infinity;
    mask_off; neg; neg on a masked lane; P + P; P + (-P) through neg;
    infinity + masked; infinity + (-Q). The rest random distinct points."""
    prng = random.Random(7)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(16)]
    ps, qs = [], []
    while len(ps) < LANES:
        p, q = prng.choice(pool), prng.choice(pool)
        if q not in (p, ech.g1_neg(p)):
            ps.append(p)
            qs.append(q)
    mask, neg = [False] * LANES, [prng.random() < 0.5 for _ in range(LANES)]
    p0, p1 = pool[0], pool[1]
    edges = [(None, p1, 0, 0), (p0, p1, 1, 0), (p0, p1, 0, 1), (p0, p1, 1, 1),
             (p0, p0, 0, 0), (p0, p0, 0, 1), (None, p1, 1, 0), (None, p1, 0, 1)]
    for i, (p, q, m, ng) in enumerate(edges):
        ps[i], qs[i], mask[i], neg[i] = p, q, bool(m), bool(ng)
    return ps, qs, mask, neg


def _k5_port(cols, qs, mask, neg, redundant: bool):
    if redundant:
        cols = [_redundant(c, Q, 20 + i) for i, c in enumerate(cols)]
    qx, qy, _ = tb.pack_affine(qs, "cpu")
    return lp.padd_mixed_packed_lazy(
        *(f.pack_ints(c, "cpu") for c in cols), tb.pack_points_dense(qx, qy),
        torch.tensor(mask), torch.tensor(neg),
    )


def _k5_jax(cols, qs, mask, neg):
    """`_mixed_add_lazy` fed as `_mixed_kernel` feeds it (lazy_point.py:150-168)."""
    qx, qy, _ = tb.pack_affine(qs, "cpu")
    w = jnp.asarray(tb.pack_points_dense(qx, qy).numpy().view(np.uint32)).T
    X2 = jlz.LV(jlp._unpack_words_f32(w[:8]), 0, 255, 1.0)
    y2 = jlp._unpack_words_f32(w[8:])
    y2 = jnp.where(jnp.asarray(neg)[None, :], PT_CONSTS[2] - y2, y2)
    out = jlp._mixed_add_lazy(QPLAN, PT_CONSTS, *_jax_acc(cols), X2, jlz.LV(y2, -255, 255, 1.0),
                              jnp.asarray(mask)[None, :])
    return out


@pytest.mark.parametrize("redundant", [False, True], ids=["canonical", "redundant"])
def test_k5_plain_matches_mixed_add_lazy(k5_lanes, redundant):
    ps, qs, mask, neg = k5_lanes
    cols = _jacobian_ints(ps, 8)
    got = _k5_port(cols, qs, mask, neg, redundant)
    assert all(max(f.unpack_ints(c)) < 2 * Q for c in got)
    want = _jax_canonical(_k5_jax(cols, qs, mask, neg))
    assert all(np.array_equal(g, w) for g, w in zip(_port_canonical(got), want))
    oracle = [p if m else (None if i in (4, 5) else ech.g1_add(p, ech.g1_neg(q) if n else q))
              for i, (p, q, m, n) in enumerate(zip(ps, qs, mask, neg))]
    assert tb.unpack_jacobian(lp.canonicalize_jp(*got)) == oracle


def test_k5_takes_a_jax_lazy_accumulator(k5_lanes):
    """A JAX-made lazy int16 accumulator (one K5 step of the JAX package,
    digits unnormalised), converted by `from_lazy_digits`, gives the same K5
    result as its canonical form."""
    ps, qs, mask, neg = k5_lanes
    lazy = [jlp._store(c) for c in _k5_jax(_jacobian_ints(ps, 9), qs, mask, neg)]
    assert any(np.asarray(c).min() < 0 or np.asarray(c).max() > 255 for c in lazy)
    acc = [f.from_lazy_digits(f.FQ, np.asarray(c), "cpu") for c in lazy]
    canonical = [f.from_ref_digits(np.asarray(c), "cpu")
                 for c in jlp.canonicalize_jp(jb.SPEC, *lazy)]
    assert all(torch.equal(a, c) for a, c in zip(acc, canonical))
    qs2 = qs[1:] + qs[:1]
    qx, qy, _ = tb.pack_affine(qs2, "cpu")
    rows, m, n = tb.pack_points_dense(qx, qy), torch.tensor(mask), torch.zeros(LANES, dtype=torch.bool)
    one = lp.canonicalize_jp(*lp.padd_mixed_packed_lazy(*acc, rows, m, n))
    two = lp.canonicalize_jp(*lp.padd_mixed_packed_lazy(*canonical, rows, m, n))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_from_lazy_digits_by_value():
    rng = np.random.default_rng(10)
    d = rng.integers(-300, 300, size=(32, 16)).astype(np.int16)
    d[31] = rng.integers(-40, 40, size=16)  # values of either sign, beyond p
    d[:, 0] = 0
    vals = [sum(int(d[i, j]) << (8 * i) for i in range(32)) for j in range(16)]
    assert min(vals[1:]) < 0 < max(vals)
    got = f.unpack_ints(f.from_lazy_digits(f.FQ, d, "cpu"))
    assert got == [v % Q for v in vals]


def test_k6_plain_matches_jacobian_add_lazy():
    """Edge lanes: P + inf, inf + Q, P + P, P + (-P), and inf + inf with P's
    infinity as (one, one, 0) and Q's as (0, 0, 0): K6 keeps P's X and Y
    there (q_inf select outermost), as the JAX package does."""
    prng = random.Random(11)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(16)]
    ps, qs = [], []
    while len(ps) < LANES:
        p, q = prng.choice(pool), prng.choice(pool)
        if q not in (p, ech.g1_neg(p)):
            ps.append(p)
            qs.append(q)
    p0 = pool[0]
    for i, (p, q) in enumerate([(p0, None), (None, p0), (p0, p0), (p0, ech.g1_neg(p0)), (None, None)]):
        ps[i], qs[i] = p, q
    pc, qc = _jacobian_ints(ps, 12, one_inf=True), _jacobian_ints(qs, 13)
    P = tuple(f.pack_ints(_redundant(c, Q, 30 + i), "cpu") for i, c in enumerate(pc))
    Qt = tuple(f.pack_ints(_redundant(c, Q, 40 + i), "cpu") for i, c in enumerate(qc))
    got = lp.padd_lazy(P, Qt)
    want = _jax_canonical(jlp._jacobian_add_lazy(QPLAN, PT_CONSTS, _jax_acc(pc), _jax_acc(qc)))
    assert all(np.array_equal(g, w) for g, w in zip(_port_canonical(got), want))
    assert f.unpack_ints(lz.canonicalize(f.FQ, got[0][:, 4:5])) == [RM]  # inf + inf: P's X
    oracle = [None if i in (2, 3) else ech.g1_add(p, q) for i, (p, q) in enumerate(zip(ps, qs))]
    assert tb.unpack_jacobian(lp.canonicalize_jp(*got)) == oracle


def test_lazy_wrappers_on_cpu_run_the_plain_versions_and_check_inputs():
    a = f.pack_ints(_values(Q, 14), "cpu")
    before = (dict(lz.LAUNCHES), dict(lp.LAUNCHES))
    assert torch.equal(lz.mont_mul_lazy(f.FQ, a, a), lz.mont_mul_lazy_plain(f.FQ, a, a))
    rows = torch.zeros((LANES, 16), dtype=torch.int32)
    m = torch.zeros(LANES, dtype=torch.bool)
    assert all(torch.equal(x, y) for x, y in zip(
        lp.padd_mixed_packed_lazy(a, a, a, rows, m, m),
        lp.padd_mixed_packed_lazy_plain(a, a, a, rows, m, m)))
    assert all(torch.equal(x, y) for x, y in zip(lp.padd_lazy((a, a, a), (a, a, a)),
                                                 lp.padd_lazy_plain(a, a, a, a, a, a)))
    assert (dict(lz.LAUNCHES), dict(lp.LAUNCHES)) == before  # no kernel on the CPU
    with pytest.raises(TypeError):
        lz.mont_mul_lazy(f.FQ, a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        lp.padd_mixed_packed_lazy(a, a, a, rows, m, m.to(torch.int32))
    with pytest.raises(ValueError):
        lp.padd_lazy((a, a, a), (a, a, a[:, :3]))
    inf = lp.inf_acc(4, "cpu")
    assert tb.unpack_jacobian(inf) == [None] * 4
    assert all(torch.equal(x, y) for x, y in zip(lp.to_lazy_jp(inf), inf))
