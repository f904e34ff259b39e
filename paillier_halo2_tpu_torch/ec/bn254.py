"""Batched BN254 G1 arithmetic on Fq limb tensors (Jacobian coordinates).

Counterpart of `paillier_halo2_tpu/ec/bn254.py:1`. Points are triples of
`(8, *batch)` int32 Montgomery limb tensors; infinity is Z == 0 whatever X
and Y hold — both (one, one, 0) and (0, 0, 0) occur. `padd`, `padd_mixed`
and `padd_mixed_packed` flatten the batch and run K2, K3 and K4
(`ec/point_kernels.py`) at every lane count.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ff import field as f
from . import point_kernels as pk

SPEC = f.FQ
N_LIMBS = 8

JPoint = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (X, Y, Z) Montgomery


def _flat(arrays, batch) -> tuple[list[torch.Tensor], int]:
    lanes = math.prod(batch)
    shape = (N_LIMBS,) + tuple(batch)
    return [a.expand(shape).reshape(N_LIMBS, lanes).contiguous() for a in arrays], lanes


def pdouble(p: JPoint) -> JPoint:
    """dbl-2009-l (a = 0); infinity stays infinity (Z stays 0)."""
    X, Y, Z = p
    mul = lambda a, b: f.mont_mul(SPEC, a, b)  # noqa: E731
    add = lambda a, b: f.add(SPEC, a, b)  # noqa: E731
    sub = lambda a, b: f.sub(SPEC, a, b)  # noqa: E731
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    t = add(X, B)
    t = mul(t, t)
    D = sub(sub(t, A), C)
    D = add(D, D)
    E = add(add(A, A), A)
    F = mul(E, E)
    X3 = sub(F, add(D, D))
    C8 = add(C, C)
    C8 = add(C8, C8)
    C8 = add(C8, C8)
    Y3 = sub(mul(E, sub(D, X3)), C8)
    YZ = mul(Y, Z)
    return (X3, Y3, add(YZ, YZ))


def padd(p: JPoint, q: JPoint, nodouble: bool = False) -> JPoint:
    """General Jacobian addition with every edge case resolved by masks:
    P+inf, inf+Q, P+P (doubling), P+(-P) (infinity). nodouble=True is the
    caller's promise that no lane has P == +-Q; a broken promise degrades
    to Z == 0, never to a wrong finite point."""
    batch = torch.broadcast_shapes(p[0].shape[1:], q[0].shape[1:])
    flat, _ = _flat(list(p) + list(q), batch)
    out = pk.g1_jadd(*flat, nodouble=nodouble)
    return tuple(c.reshape((N_LIMBS,) + tuple(batch)) for c in out)


def padd_mixed(p: JPoint, q_affine, q_inf, nodouble: bool = False) -> JPoint:
    """Mixed addition: q in affine Montgomery coordinates, `q_inf` a batch
    mask of affine operands at infinity."""
    X2, Y2 = q_affine
    batch = torch.broadcast_shapes(p[0].shape[1:], X2.shape[1:])
    flat, lanes = _flat(list(p) + [X2, Y2], batch)
    qi = torch.broadcast_to(q_inf, tuple(batch)).reshape(lanes).contiguous()
    out = pk.g1_madd(*flat, qi, nodouble=nodouble)
    return tuple(c.reshape((N_LIMBS,) + tuple(batch)) for c in out)


def padd_mixed_packed(p: JPoint, packed: torch.Tensor, q_inf, nodouble: bool = False) -> JPoint:
    """Mixed add with the affine operand as (L, 16) rows — what a row gather
    from `pack_points_dense` gives. p's coordinates are (8, L)."""
    X1, Y1, Z1 = (c.contiguous() for c in p)
    return pk.g1_madd_packed(X1, Y1, Z1, packed.contiguous(), q_inf.contiguous(), nodouble)


def pack_points_dense(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """(8, N) x 2 -> (N, 16) rows: words 0-7 = X limbs, 8-15 = Y limbs — the
    same uint32 words as the JAX package's `pack_points_dense`."""
    return torch.cat([px, py], dim=0).t().contiguous()


# -- host <-> device -------------------------------------------------------------


def pack_affine(points, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host affine points (or None) -> Montgomery (X, Y, inf_mask) tensors."""
    R = SPEC.r_mod_p
    q = SPEC.p
    xm = f.pack_ints([p[0] * R % q if p is not None else 0 for p in points], device)
    ym = f.pack_ints([p[1] * R % q if p is not None else 0 for p in points], device)
    inf = torch.tensor(np.array([p is None for p in points], dtype=bool), device=device)
    return xm, ym, inf


def pack_jacobian(points, device) -> JPoint:
    """Host affine points (or None) -> Jacobian Montgomery tensors."""
    xm, ym, inf = pack_affine(points, device)
    one = SPEC.limbs("one_mont", device)[:, None].expand_as(xm)
    z = torch.where(inf, torch.zeros_like(xm), one)
    return (xm, ym, z.contiguous())


def unpack_jacobian(p: JPoint):
    """Jacobian tensors -> flat list of host affine points (or None)."""
    xs, ys, zs = (f.unpack_ints(f.from_mont(SPEC, c)) for c in p)
    q = SPEC.p
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, q)
        zi2 = zi * zi % q
        out.append((x * zi2 % q, y * zi2 * zi % q))
    return out
