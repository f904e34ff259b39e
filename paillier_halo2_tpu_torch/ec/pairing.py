"""BN254 ate pairing on the host — verifier-side only (2 pairings per KZG
check, SURVEY.md section 2.2 "pairing (verify only)"). Python-int Fq12 tower
arithmetic; throughput is irrelevant here, correctness is everything, so the
implementation favors the simple polynomial-basis construction:

    Fq12 = Fq[w] / (w^12 - 18 w^6 + 82)

with the sextic twist embedding u -> w^6 - 9 (so Fq2 = Fq[u]/(u^2+1) embeds
into Fq12), Miller loop over the BN ate loop count 6t+2, and final
exponentiation by (p^12 - 1)/r done with a plain square-and-multiply.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/ec/pairing.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

from ..ff.host import FQ_MOD as Q
from ..ff.host import FR_MOD as R
from .host import Fq2, Point, PointG2

# BN254 curve parameter t and ate loop count 6t+2.
BN_T = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_T + 2  # 29793968203157093288

# Fq12 modulus: w^12 - 18w^6 + 82 (monic; coefficients of lower terms).
_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)


class FQ12:
    """Element of Fq12 as a degree-<12 polynomial over Fq."""

    __slots__ = ("c",)

    def __init__(self, coeffs) -> None:
        assert len(coeffs) == 12
        self.c = tuple(x % Q for x in coeffs)

    @classmethod
    def one(cls) -> "FQ12":
        return cls((1,) + (0,) * 11)

    @classmethod
    def zero(cls) -> "FQ12":
        return cls((0,) * 12)

    @classmethod
    def from_fq(cls, x: int) -> "FQ12":
        return cls((x,) + (0,) * 11)

    @classmethod
    def from_fq2(cls, x: Fq2) -> "FQ12":
        """Embed a+bu via u = w^6 - 9."""
        a, b = x
        c = [0] * 12
        c[0] = (a - 9 * b) % Q
        c[6] = b % Q
        return cls(c)

    def __add__(self, o: "FQ12") -> "FQ12":
        return FQ12([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o: "FQ12") -> "FQ12":
        return FQ12([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self) -> "FQ12":
        return FQ12([-a for a in self.c])

    def __mul__(self, o) -> "FQ12":
        if isinstance(o, int):
            return FQ12([a * o for a in self.c])
        t = [0] * 23
        for i, a in enumerate(self.c):
            if a:
                for j, b in enumerate(o.c):
                    t[i + j] += a * b
        # Reduce degrees 22..12 by w^12 = 18w^6 - 82.
        for d in range(22, 11, -1):
            v = t[d]
            if v:
                t[d] = 0
                t[d - 6] += 18 * v
                t[d - 12] -= 82 * v
        return FQ12(t[:12])

    __rmul__ = __mul__

    def __eq__(self, o) -> bool:
        return isinstance(o, FQ12) and self.c == o.c

    def is_zero(self) -> bool:
        return all(x == 0 for x in self.c)

    def inv(self) -> "FQ12":
        """Extended Euclid over Fq[w] against the field modulus."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [x % Q for x in _MOD_COEFFS] + [1]

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i]:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = list(a)
            o = [0] * len(a)
            binv = pow(b[degb], -1, Q)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % Q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % Q
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                    new[i + j] = (new[i + j] - low[i] * r[j]) % Q
            high, low, hm, lm = low, new, lm, nm
        c0_inv = pow(low[0], -1, Q)
        return FQ12([x * c0_inv % Q for x in lm[:12]])

    def pow(self, e: int) -> "FQ12":
        acc = FQ12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc


# -- curve over Fq12 ---------------------------------------------------------

Pt12 = tuple[FQ12, FQ12] | None


def _twist(p: PointG2) -> Pt12:
    """Map a G2 (twist curve) point into E(Fq12)."""
    if p is None:
        return None
    x, y = p
    nx = FQ12.from_fq2(x)
    ny = FQ12.from_fq2(y)
    w = FQ12((0, 1) + (0,) * 10)
    return (nx * w.pow(2), ny * w.pow(3))


def _cast_g1(p: Point) -> Pt12:
    if p is None:
        return None
    return (FQ12.from_fq(p[0]), FQ12.from_fq(p[1]))


def _double12(p: Pt12) -> Pt12:
    if p is None:
        return None
    x, y = p
    if y.is_zero():
        return None
    lam = (3 * (x * x)) * (2 * y).inv()
    nx = lam * lam - 2 * x
    ny = lam * (x - nx) - y
    return (nx, ny)


def _add12(p: Pt12, q: Pt12) -> Pt12:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        return _double12(p)
    lam = (y2 - y1) * (x2 - x1).inv()
    nx = lam * lam - x1 - x2
    ny = lam * (x1 - nx) - y1
    return (nx, ny)


def _linefunc(p1: Pt12, p2: Pt12, t: Pt12) -> FQ12:
    """Evaluate the line through p1, p2 at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) * (2 * y1).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q12: Pt12, p12: Pt12) -> FQ12:
    if q12 is None or p12 is None:
        return FQ12.one()
    r = q12
    f = FQ12.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(r, r, p12)
        r = _double12(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, q12, p12)
            r = _add12(r, q12)
    # Frobenius endomorphism terms (pi(Q) and -pi^2(Q)).
    q1 = (q12[0].pow(Q), q12[1].pow(Q))
    nq2 = (q1[0].pow(Q), -(q1[1].pow(Q)))
    f = f * _linefunc(r, q1, p12)
    r = _add12(r, q1)
    f = f * _linefunc(r, nq2, p12)
    return f


_FINAL_EXP = (Q**12 - 1) // R


def pairing(p: Point, q: PointG2) -> FQ12:
    """e(P, Q) for P in G1, Q in G2."""
    if p is None or q is None:
        return FQ12.one()
    return miller_loop(_twist(q), _cast_g1(p)).pow(_FINAL_EXP)


def pairing_check(pairs: list[tuple[Point, PointG2]]) -> bool:
    """prod e(P_i, Q_i) == 1 — the KZG verification equation shape.
    Dispatches to the native C++ engine (native/bn254.cpp) when available."""
    from .host import _native

    nat = _native()
    if nat is not None:
        return nat.pairing_check(pairs)
    acc = FQ12.one()
    for p, q in pairs:
        acc = acc * miller_loop(_twist(q), _cast_g1(p))
    return acc.pow(_FINAL_EXP) == FQ12.one()
