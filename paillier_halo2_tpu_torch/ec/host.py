"""Host (Python-int) BN254 G1/G2 arithmetic — oracle for the device path and
the verifier-side small computations. Affine coordinates, None = infinity.
Replaces the host-facing slice of halo2curves (SURVEY.md section 2.2).

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/ec/host.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

from ..ff.host import FQ_MOD as Q
from ..ff.host import FR_MOD as R
from ..ff.host import G1_GEN, G2_GEN

Point = tuple[int, int] | None  # affine; None = point at infinity
Fq2 = tuple[int, int]  # c0 + c1*u, u^2 = -1
PointG2 = tuple[Fq2, Fq2] | None


def _native():
    """The C++ host engine (native/bn254.cpp), or None — lazy, import-safe."""
    from .. import native

    return native if native.lib() is not None else None


# -- G1 (over Fq) ------------------------------------------------------------


def g1_is_on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0


def g1_neg(p: Point) -> Point:
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_add(p: Point, q: Point) -> Point:
    if p is None:
        return q
    if q is None:
        return p
    nat = _native()
    if nat is not None:
        return nat.g1_add(p, q)
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_double(p: Point) -> Point:
    return g1_add(p, p)


def g1_mul(p: Point, k: int) -> Point:
    k %= R
    nat = _native()
    if nat is not None:
        return nat.g1_mul(p, k)
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_double(p)
        k >>= 1
    return acc


def g1_msm(points: list[Point], scalars: list[int]) -> Point:
    nat = _native()
    if nat is not None:
        return nat.g1_msm(points, [s % R for s in scalars])
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


# -- Fq2 ---------------------------------------------------------------------


def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    return (
        (a[0] * b[0] - a[1] * b[1]) % Q,
        (a[0] * b[1] + a[1] * b[0]) % Q,
    )


def fq2_inv(a: Fq2) -> Fq2:
    d = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
    return (a[0] * d % Q, (-a[1]) * d % Q)


def fq2_neg(a: Fq2) -> Fq2:
    return ((-a[0]) % Q, (-a[1]) % Q)


# G2 curve: y^2 = x^3 + b2 with b2 = 3 / (9 + u).
B2: Fq2 = fq2_mul((3, 0), fq2_inv((9, 1)))


def g2_is_on_curve(p: PointG2) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = fq2_mul(y, y)
    rhs = fq2_add(fq2_mul(fq2_mul(x, x), x), B2)
    return lhs == rhs


def g2_add(p: PointG2, q: PointG2) -> PointG2:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == (0, 0):
            return None
        lam = fq2_mul(fq2_mul((3, 0), fq2_mul(x1, x1)), fq2_inv(fq2_add(y1, y1)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p: PointG2, k: int) -> PointG2:
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


G1 = G1_GEN
G2 = G2_GEN
