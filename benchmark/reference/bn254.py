"""BN254 in plain Python integers: the two fields, G1 in Jacobian form, and
the constants of the proof system's domain.

Written for the benchmark's reference and independent of the program: it
imports neither torch nor anything of the measured package. Points leave
and enter as affine `(x, y)` tuples, `None` for the point at infinity.
"""
from __future__ import annotations

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617  # Fr
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583  # Fq
G1 = (1, 2)  # y^2 = x^3 + 3

FR_TWO_ADICITY = 28
FR_GENERATOR = 5
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
# Generator of the odd part of Fr*: the cosets delta^j * H of the
# permutation argument's identity columns are disjoint.
DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, R)
MONT_R = 1 << 256  # the Montgomery radix of the program's limb tensors
MONT_R_INV = pow(MONT_R, -1, R)


def root_of_unity(k: int) -> int:
    """A primitive 2^k-th root of unity in Fr."""
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), R)


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0


def _jdbl(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _jadd(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _jdbl(p) if s1 == s2 else (1, 1, 0)
    h = (u2 - u1) % Q
    r = (s2 - s1) % Q
    hh = h * h % Q
    hhh = h * hh % Q
    v = u1 * hh % Q
    x3 = (r * r - hhh - 2 * v) % Q
    y3 = (r * (v - x3) - s1 * hhh) % Q
    z3 = z1 * z2 * h % Q
    return (x3, y3, z3)


def _jac(p):
    return (1, 1, 0) if p is None else (p[0], p[1], 1)


def _affine(p):
    if p[2] == 0:
        return None
    zi = pow(p[2], -1, Q)
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 * zi % Q)


def _jmul(p, k: int):
    acc = (1, 1, 0)
    for bit in bin(k % R)[2:]:
        acc = _jdbl(acc)
        if bit == "1":
            acc = _jadd(acc, p)
    return acc


def mul(p, k: int):
    """[k]p, affine in and out."""
    return _affine(_jmul(_jac(p), k))


def add(p, q):
    return _affine(_jadd(_jac(p), _jac(q)))


def neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def lincomb(pairs) -> tuple | None:
    """sum of [k_i]p_i over (p_i, k_i) pairs."""
    acc = (1, 1, 0)
    for p, k in pairs:
        acc = _jadd(acc, _jmul(_jac(p), k))
    return _affine(acc)
