"""K5, K6: the signed-window MSM's G1 additions on redundant-form
accumulators — the wrappers around `csrc/g1_add_lazy.cu` and their plain
PyTorch versions.

Counterpart of `paillier_halo2_tpu/ec/lazy_point.py:1`:

- `padd_mixed_packed_lazy` (K5) <- `padd_mixed_packed_lazy` (:172): one bucket
  step, accumulator + (+-P) with P from packed `(N, 16)` rows; `neg` lanes
  use p - y, `mask_off` lanes pass the accumulator through;
- `padd_lazy` (K6) <- `padd_lazy` (:220): Jacobian + Jacobian, either side
  possibly at infinity, the q_inf select outermost (:124-126);
- `inf_acc`, `to_lazy_jp`, `canonicalize_jp` <- :243-270, the pipeline's
  entry and exit.

Accumulator coordinates are `(8, N)` int32 Fq limbs in Montgomery form with
values in [0, 2p) (`ff/lazy_mont.py`); infinity is Z == 0 exactly, which
every redundant-form operation preserves. Both kernels are nodouble only: a
lane with P == +-Q degrades to a Z that is zero mod p, which
`canonicalize_jp` maps to exact zero, never to a wrong finite point. On a
CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version, which takes the same products, sums, differences and
selects in the same order, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from ..ff import lazy_mont as lz
from ..ff.field import is_zero as _is_zero
from ..ff.limbs16 import M32, to_i32, u64
from ..utils import kernels
from .point_kernels import PACK_WORDS, SPEC, _check, _outputs, _sel, unpack_rows

LAUNCHES = {"padd_mixed_packed_lazy": 0, "padd_lazy": 0}


def _mul(a, b):
    return lz.mont_mul_lazy_plain(SPEC, a, b)


def _add(a, b):
    return lz.add_lazy(SPEC, a, b)


def _sub(a, b):
    return lz.sub_lazy(SPEC, a, b)


def _neg_y(y, neg):
    """p - y on `neg` lanes (y canonical, so p - y is in (0, p])."""
    uy = u64(y)
    out, bw = [], 0
    for k in range(8):
        x = SPEC.p_limbs[k] - uy[k] - bw
        out.append(x & M32)
        bw = (x >> 32) & 1
    return torch.where(neg, to_i32(torch.stack(out)), y)


def padd_mixed_packed_lazy_plain(X1, Y1, Z1, packed, mask_off, neg):
    """K5's function: `_mixed_add_lazy` (lazy_point.py:51-92) with the
    operand from packed rows, negated where `neg` is set (:157-159)."""
    X2, Y2 = unpack_rows(packed)
    Y2 = _neg_y(Y2, neg)
    z1z1 = _mul(Z1, Z1)
    u2 = _mul(X2, z1z1)
    s2 = _mul(Y2, _mul(Z1, z1z1))
    h = _sub(u2, X1)
    r = _sub(s2, Y1)
    hh = _mul(h, h)
    hhh = _mul(h, hh)
    v = _mul(X1, hh)
    rr = _mul(r, r)
    X3 = _sub(_sub(rr, hhh), _add(v, v))
    Y3 = _sub(_mul(r, _sub(v, X3)), _mul(Y1, hhh))
    Z3 = _mul(Z1, h)
    p_inf = _is_zero(Z1)
    one = SPEC.limbs("one_mont", X1.device)[:, None].expand_as(X1)
    zero = torch.zeros_like(X1)
    X3, Y3 = _sel(p_inf, X2, X3), _sel(p_inf, Y2, Y3)
    Z3 = _sel(p_inf, _sel(mask_off, zero, one), Z3)
    X3, Y3, Z3 = _sel(mask_off, X1, X3), _sel(mask_off, Y1, Y3), _sel(mask_off, Z1, Z3)
    return X3, Y3, Z3


def padd_lazy_plain(X1, Y1, Z1, X2, Y2, Z2):
    """K6's function: `_jacobian_add_lazy` (lazy_point.py:95-129)."""
    z1z1 = _mul(Z1, Z1)
    z2z2 = _mul(Z2, Z2)
    u1 = _mul(X1, z2z2)
    u2 = _mul(X2, z1z1)
    s1 = _mul(Y1, _mul(Z2, z2z2))
    s2 = _mul(Y2, _mul(Z1, z1z1))
    h = _sub(u2, u1)
    r = _sub(s2, s1)
    hh = _mul(h, h)
    hhh = _mul(h, hh)
    v = _mul(u1, hh)
    rr = _mul(r, r)
    X3 = _sub(_sub(rr, hhh), _add(v, v))
    Y3 = _sub(_mul(r, _sub(v, X3)), _mul(s1, hhh))
    Z3 = _mul(_mul(Z1, Z2), h)
    p_inf = _is_zero(Z1)
    q_inf = _is_zero(Z2)
    X3 = _sel(q_inf, X1, _sel(p_inf, X2, X3))
    Y3 = _sel(q_inf, Y1, _sel(p_inf, Y2, Y3))
    Z3 = _sel(q_inf, Z1, _sel(p_inf, Z2, Z3))
    return X3, Y3, Z3


# -- wrappers ------------------------------------------------------------------


def padd_mixed_packed_lazy(X1, Y1, Z1, packed, mask_off, neg):
    """K5: accumulators (8, N) + the (N, 16) int32 packed rows, `mask_off`
    and `neg` (N,) bool masks."""
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check(
        "padd_mixed_packed_lazy", (X1, Y1, Z1), n, X1.device,
        [(packed, torch.int32, (n, PACK_WORDS)), (mask_off, torch.bool, (n,)),
         (neg, torch.bool, (n,))],
    )
    if X1.device.type == "cpu":
        return padd_mixed_packed_lazy_plain(X1, Y1, Z1, packed, mask_off, neg)
    out = _outputs(X1)
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_madd_lazy(
        X1.data_ptr(), Y1.data_ptr(), Z1.data_ptr(), packed.data_ptr(), mask_off.data_ptr(),
        neg.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), n,
        kernels.stream_ptr(X1.device),
    )
    kernels.check(rc, "padd_mixed_packed_lazy")
    LAUNCHES["padd_mixed_packed_lazy"] += 1
    return out


def padd_lazy(P1, P2):
    """K6: P1 + P2, each a triple of (8, N) redundant-form coordinates."""
    coords = tuple(P1) + tuple(P2)
    X1 = coords[0]
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check("padd_lazy", coords, n, X1.device)
    if X1.device.type == "cpu":
        return padd_lazy_plain(*coords)
    out = _outputs(X1)
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_jadd_lazy(
        *(c.data_ptr() for c in coords), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), n, kernels.stream_ptr(X1.device),
    )
    kernels.check(rc, "padd_lazy")
    LAUNCHES["padd_lazy"] += 1
    return out


# -- the pipeline's entry and exit ------------------------------------------------


def inf_acc(n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n fresh accumulators at infinity: (one, one, 0), as `inf_acc` (:243)."""
    one = SPEC.limbs("one_mont", device)[:, None].expand(8, n).contiguous()
    return one, one.clone(), torch.zeros((8, n), dtype=torch.int32, device=device)


def to_lazy_jp(p):
    """Canonical Jacobian coordinates -> accumulators (:253). Canonical
    values already lie in [0, 2p), so this only makes them contiguous."""
    return tuple(c.contiguous() for c in p)


def canonicalize_jp(X, Y, Z):
    """Accumulators -> canonical Jacobian coordinates in [0, p) (:259). A Z
    that is zero mod p (p itself, from a broken nodouble contract) becomes
    exact zero, the infinity encoding."""
    return tuple(lz.canonicalize(SPEC, c) for c in (X, Y, Z))
