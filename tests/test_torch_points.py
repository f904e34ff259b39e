"""The PyTorch port's G1 point layer (`ec/bn254.py` and the plain versions of
K2, K3 and K4 in `ec/point_kernels.py`) against the JAX package's
`ec/bn254.py` (XLA path on the CPU) and the host oracle `ec/host`.

Lanes hold random distinct points in Jacobian form with random Z, plus the
edge cases P+inf, inf+Q (with both infinity encodings, (1, 1, 0) and
(0, 0, 0)), P+P, P+(-P) and inf+inf. Comparisons are exact. The JAX
package's XLA path keeps the doubling branch under `nodouble`, so there the
contract-breaking lanes are checked against the port's own rule: they
degrade to Z == 0. The kernels themselves are held against these plain
versions on the card in `test_torch_cuda.py`.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ec import bn254 as jb
from paillier_halo2_tpu.ff import field_jax as fj
from paillier_halo2_tpu_torch.ec import bn254 as tb
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ec import point_kernels as pk
from paillier_halo2_tpu_torch.ff import field as f

LANES = 64
Q = ech.Q
RM = (1 << 256) % Q
# lanes 0..5: P+inf, inf+Q (Z=0, X=Y=0), inf+Q (X=Y=one), P+P, P+(-P), inf+inf
CONTRACT_BREAKERS = (3, 4)


def _lanes(seed: int, n: int = LANES):
    prng = random.Random(seed)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(16)]
    ps, qs = [], []
    while len(ps) < n:
        p, q = prng.choice(pool), prng.choice(pool)
        if q not in (p, ech.g1_neg(p)):
            ps.append(p)
            qs.append(q)
    p0 = pool[0]
    edges = [(p0, None), (None, p0), (None, p0), (p0, p0), (p0, ech.g1_neg(p0)), (None, None)]
    for i, (p, q) in enumerate(edges):
        ps[i], qs[i] = p, q
    return ps, qs


def _jacobian_ints(points, seed: int, one_inf=()):
    """Montgomery (X, Y, Z) int lists with random Z; infinity is (0, 0, 0),
    or (one, one, 0) for the lanes in `one_inf`."""
    prng = random.Random(seed)
    cols = ([], [], [])
    for i, p in enumerate(points):
        if p is None:
            o = 1 if i in one_inf else 0
            vals = (o, o, 0)
        else:
            z = prng.randrange(1, Q)
            vals = (p[0] * z * z % Q, p[1] * z * z * z % Q, z)
        for c, v in zip(cols, vals):
            c.append(v * RM % Q)
    return cols


def _both(cols):
    """Int columns -> (port tensors, JAX digit arrays)."""
    return (tuple(f.pack_ints(c, "cpu") for c in cols),
            tuple(jnp.asarray(fj.pack_ints(c)) for c in cols))


def _same(tp, jp, lanes=None) -> bool:
    lanes = slice(None) if lanes is None else lanes
    return all(
        np.array_equal(f.to_ref_digits(t)[:, lanes], np.asarray(j, np.uint32)[:, lanes])
        for t, j in zip(tp, jp)
    )


@pytest.fixture(scope="module")
def lanes():
    ps, qs = _lanes(11)
    P_t, P_j = _both(_jacobian_ints(ps, 12, one_inf=(2,)))
    Q_t, Q_j = _both(_jacobian_ints(qs, 13))
    qx_t, qy_t, qinf_t = tb.pack_affine(qs, "cpu")
    qx_j, qy_j, qinf_j = jb.pack_affine(qs)
    return {
        "ps": ps, "qs": qs, "P": (P_t, P_j), "Q": (Q_t, Q_j),
        "aff_t": (qx_t, qy_t, qinf_t),
        "aff_j": (jnp.asarray(qx_j), jnp.asarray(qy_j), jnp.asarray(qinf_j)),
        "want": [ech.g1_add(p, q) for p, q in zip(ps, qs)],
    }


def _run(kind, lanes, nodouble):
    (P_t, P_j), (Q_t, Q_j) = lanes["P"], lanes["Q"]
    qx_t, qy_t, qinf_t = lanes["aff_t"]
    qx_j, qy_j, qinf_j = lanes["aff_j"]
    if kind == "jadd":
        return tb.padd(P_t, Q_t, nodouble), jb.padd(P_j, Q_j, nodouble=nodouble)
    if kind == "madd":
        return (tb.padd_mixed(P_t, (qx_t, qy_t), qinf_t, nodouble),
                jb.padd_mixed(P_j, (qx_j, qy_j), qinf_j, nodouble=nodouble))
    packed_t = tb.pack_points_dense(qx_t, qy_t)
    packed_j = jb.pack_points_dense(qx_j, qy_j)
    assert np.array_equal(packed_t.numpy().view(np.uint32), np.asarray(packed_j))
    return (tb.padd_mixed_packed(P_t, packed_t, qinf_t, nodouble),
            jb.padd_mixed_packed(P_j, packed_j, qinf_j, nodouble=nodouble))


@pytest.mark.parametrize("kind", ["jadd", "madd", "madd_packed"])
def test_full_add_matches_bn254_and_host(lanes, kind):
    got_t, got_j = _run(kind, lanes, nodouble=False)
    assert _same(got_t, got_j)  # the Jacobian representation, bit for bit
    assert tb.unpack_jacobian(got_t) == lanes["want"]


@pytest.mark.parametrize("kind", ["jadd", "madd", "madd_packed"])
def test_nodouble_add_matches_and_degrades_to_infinity(lanes, kind):
    got_t, got_j = _run(kind, lanes, nodouble=True)
    keep = [i for i in range(LANES) if i not in CONTRACT_BREAKERS]
    assert _same(got_t, got_j, keep)
    z = f.unpack_ints(got_t[2])
    assert all(z[i] == 0 for i in CONTRACT_BREAKERS)  # never a wrong finite point
    pts = tb.unpack_jacobian(got_t)
    assert [pts[i] for i in keep] == [lanes["want"][i] for i in keep]


def test_pdouble_matches_bn254(lanes):
    (P_t, P_j) = lanes["P"]
    got_t = tb.pdouble(P_t)
    assert _same(got_t, jb.pdouble(P_j))
    assert tb.unpack_jacobian(got_t) == [ech.g1_double(p) for p in lanes["ps"]]


def test_pack_and_unpack_match_bn254(lanes):
    qs = lanes["qs"]
    for t, j in zip(tb.pack_affine(qs, "cpu")[:2], jb.pack_affine(qs)[:2]):
        assert np.array_equal(f.to_ref_digits(t), j)
    assert np.array_equal(tb.pack_affine(qs, "cpu")[2].numpy(), jb.pack_affine(qs)[2])
    jac_t = tb.pack_jacobian(qs, "cpu")
    assert _same(jac_t, jb.pack_jacobian(qs))
    assert tb.unpack_jacobian(jac_t) == qs == jb.unpack_jacobian(jb.pack_jacobian(qs))


def test_batch_axes_broadcast(lanes):
    P_t = lanes["P"][0]
    Q_t = lanes["Q"][0]
    flat = tb.padd(P_t, Q_t)
    shaped = tb.padd(tuple(c.reshape(8, 4, 16) for c in P_t), tuple(c.reshape(8, 4, 16) for c in Q_t))
    assert all(torch.equal(a, b.reshape(8, LANES)) for a, b in zip(flat, shaped))


@pytest.mark.parametrize("bad", ["q_inf_dtype", "packed_shape", "coord_dtype", "meta"])
def test_point_wrappers_reject_bad_inputs(lanes, bad):
    P_t = lanes["P"][0]
    qx, qy, qinf = lanes["aff_t"]
    packed = tb.pack_points_dense(qx, qy)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        if bad == "q_inf_dtype":
            pk.g1_madd(*P_t, qx, qy, qinf.to(torch.int32))
        elif bad == "packed_shape":
            pk.g1_madd_packed(*P_t, packed[:, :8].contiguous(), qinf)
        elif bad == "coord_dtype":
            pk.g1_jadd(*P_t, P_t[0].to(torch.int64), *P_t[1:])
        else:
            meta = [c.to("meta") for c in P_t]
            pk.g1_jadd(*meta, *meta)
