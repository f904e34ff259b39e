"""A plain verifier of the program's SHPLONK proofs, with the SRS's secret.

A frozen copy of the published protocol (halo2's Blake2b transcript
framing, the single custom gate q * (a + a(w) a(w^2) - a(w^3)), the
permutation in chunks of two columns, one lookup per lookup column into the
range table, SHPLONK over the rotation sets), written against this
package's own arithmetic. Its last step differs from a verifier's: where a
verifier checks e(Q, [tau]_2) == e(L + u Q, [1]_2), which holds exactly when
[tau - u]Q == L, the reference knows tau and checks that equation in G1.
"""
from __future__ import annotations

import hashlib

from .bn254 import DELTA, G1, Q, R, lincomb, mul, on_curve, root_of_unity

_SIGN = 0x80


def _fe(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def point_from_bytes(raw: bytes):
    if raw == bytes(32):
        raise ValueError("point at infinity in proof")
    buf = bytearray(raw)
    sign = (buf[31] & _SIGN) >> 7
    buf[31] &= ~_SIGN & 0xFF
    x = int.from_bytes(bytes(buf), "little")
    if x >= Q:
        raise ValueError("x out of range")
    rhs = (pow(x, 3, Q) + 3) % Q
    y = pow(rhs, (Q + 1) // 4, Q)
    if y * y % Q != rhs:
        raise ValueError("x not on curve")
    if (y & 1) != sign:
        y = Q - y
    return (x, y)


class Transcript:
    """halo2's Blake2b transcript, reading side."""

    def __init__(self, proof: bytes):
        self._h = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self._buf = proof
        self._pos = 0

    def common_point(self, p) -> None:
        if p is None:
            raise ValueError("cannot absorb infinity")
        self._h.update(b"\x01" + _fe(p[0]) + _fe(p[1]))

    def _take(self, m: int) -> bytes:
        if self._pos + m > len(self._buf):
            raise ValueError("transcript exhausted")
        out = self._buf[self._pos : self._pos + m]
        self._pos += m
        return out

    def read_point(self):
        p = point_from_bytes(self._take(32))
        self.common_point(p)
        return p

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(32), "little")
        if s >= R:
            raise ValueError("scalar out of range")
        self._h.update(b"\x02" + _fe(s))
        return s

    def squeeze(self) -> int:
        self._h.update(b"\x00")
        return int.from_bytes(self._h.copy().digest(), "little") % R

    def consumed(self) -> bool:
        return self._pos == len(self._buf)


def _lagrange_at(i: int, x: int, n: int, w: int) -> int:
    wi = pow(w, i, R)
    return wi * (pow(x, n, R) - 1) % R * pow(n * (x - wi) % R, -1, R) % R


def _point_set(kind: str, i: int, nz: int) -> tuple[str, ...]:
    if kind == "adv":
        return ("x", "wx", "w2x", "w3x")
    if kind == "zp":
        return ("x", "wx", "wux") if nz > 1 and i < nz - 1 else ("x", "wx")
    if kind == "zl":
        return ("x", "wx")
    if kind == "ap":
        return ("x", "winvx")
    return ("x",)


KINDS = ("adv", "lk", "q", "fc", "table", "sigma", "zp", "zl", "ap", "sp", "t")


def verify(vk, proof: bytes, tau: int) -> tuple[bool, str]:
    """(accepted, the failed step or "") for a SHPLONK proof under `vk`."""
    try:
        return _verify(vk, proof, tau)
    except ValueError as e:
        return False, f"malformed: {e}"


def _verify(vk, proof: bytes, tau: int) -> tuple[bool, str]:
    L = vk.layout
    k, n, usable = L.k, L.n, L.usable
    na, nl = L.num_advice, L.num_lookup_advice
    chunks = L.perm_chunks
    nz, npc, n_pieces = len(chunks), L.n_perm_cols, 3
    tr = Transcript(proof)
    for c in vk.fixed_commitments():
        tr.common_point(c)
    adv_c = [tr.read_point() for _ in range(na)]
    lk_c = [tr.read_point() for _ in range(nl)]
    ap_c = [tr.read_point() for _ in range(nl)]
    sp_c = [tr.read_point() for _ in range(nl)]
    beta, gamma = tr.squeeze(), tr.squeeze()
    zp_c = [tr.read_point() for _ in range(nz)]
    zl_c = [tr.read_point() for _ in range(nl)]
    y = tr.squeeze()
    t_c = [tr.read_point() for _ in range(n_pieces)]
    x = tr.squeeze()
    w = root_of_unity(k)
    points = {"x": x, "wx": x * w % R, "w2x": x * w * w % R, "w3x": x * pow(w, 3, R) % R,
              "winvx": x * pow(w, -1, R) % R, "wux": x * pow(w, usable, R) % R}

    evx = [tr.read_scalar() for _ in range(na + nl + na + 2 + npc + nz + 3 * nl + n_pieces)]
    evwx = [tr.read_scalar() for _ in range(na + nz + nl)]
    evw2x = [tr.read_scalar() for _ in range(na)]
    evw3x = [tr.read_scalar() for _ in range(na)]
    evwinvx = [tr.read_scalar() for _ in range(nl)]
    evwux = [tr.read_scalar() for _ in range(nz - 1)]
    at_x, pos = {}, 0
    for kind, m in (("adv", na), ("lk", nl), ("q", na), ("fc", 1), ("table", 1), ("sigma", npc),
                    ("zp", nz), ("zl", nl), ("ap", nl), ("sp", nl), ("t", n_pieces)):
        at_x[kind] = evx[pos : pos + m]
        pos += m
    adv_x, lk_x, q_x = at_x["adv"], at_x["lk"], at_x["q"]
    (fc_x,), (table_x,), sigma_x = at_x["fc"], at_x["table"], at_x["sigma"]
    zp_x, zl_x, ap_x, sp_x, t_x = at_x["zp"], at_x["zl"], at_x["ap"], at_x["sp"], at_x["t"]
    adv_wx, zp_wx, zl_wx = evwx[:na], evwx[na : na + nz], evwx[na + nz :]

    xn = pow(x, n, R)
    l0 = _lagrange_at(0, x, n, w)
    lu = _lagrange_at(usable, x, n, w)
    active = (1 - sum(_lagrange_at(i, x, n, w) for i in range(usable, n))) % R

    cons = [q_x[c] * (adv_x[c] + adv_wx[c] * evw2x[c] - evw3x[c]) % R for c in range(na)]
    cons.append(l0 * (zp_x[0] - 1) % R)
    cols = adv_x + lk_x + [fc_x]
    for ci, chunk in enumerate(chunks):
        lhs, rhs = zp_wx[ci], zp_x[ci]
        for j in chunk:
            lhs = lhs * ((cols[j] + beta * sigma_x[j] + gamma) % R) % R
            rhs = rhs * ((cols[j] + beta * pow(DELTA, j, R) * x + gamma) % R) % R
        cons.append(active * (lhs - rhs) % R)
    for ci in range(1, nz):
        cons.append(l0 * (zp_x[ci] - evwux[ci - 1]) % R)
    cons.append(lu * (zp_x[-1] - 1) % R)
    for i in range(nl):
        cons.append(l0 * (zl_x[i] - 1) % R)
        cons.append(lu * (zl_x[i] - 1) % R)
        lhs = zl_wx[i] * (ap_x[i] + beta) % R * ((sp_x[i] + gamma) % R) % R
        rhs = zl_x[i] * (lk_x[i] + beta) % R * ((table_x + gamma) % R) % R
        cons.append(active * (lhs - rhs) % R)
        d1 = (ap_x[i] - sp_x[i]) % R
        cons.append(active * d1 % R * ((ap_x[i] - evwinvx[i]) % R) % R)
        cons.append(l0 * d1 % R)
    acc = 0
    for c in cons:
        acc = (acc * y + c) % R
    t_eval = 0
    for tj in reversed(t_x):
        t_eval = (t_eval * xn + tj) % R
    if acc != t_eval * (xn - 1) % R:
        return False, "quotient identity"

    # SHPLONK
    yy, v = tr.squeeze(), tr.squeeze()
    h_c = tr.read_point()
    u = tr.squeeze()
    q_c = tr.read_point()
    if not tr.consumed():
        return False, "trailing bytes"
    commits = {"adv": adv_c, "lk": lk_c, "q": vk.q_commits, "fc": [vk.fixed_const_commit],
               "table": [vk.table_commit], "sigma": vk.sigma_commits, "zp": zp_c, "zl": zl_c,
               "ap": ap_c, "sp": sp_c, "t": t_c}
    evals = {"x": at_x, "wx": {"adv": adv_wx, "zp": zp_wx, "zl": zl_wx}, "w2x": {"adv": evw2x},
             "w3x": {"adv": evw3x}, "winvx": {"ap": evwinvx}, "wux": {"zp": evwux}}
    counts = {kd: len(commits[kd]) for kd in KINDS}
    groups: list[tuple[tuple[str, ...], list]] = []
    index: dict = {}
    for kind in KINDS:
        for i in range(counts[kind]):
            pts = _point_set(kind, i, nz)
            if pts not in index:
                index[pts] = len(groups)
                groups.append((pts, []))
            groups[index[pts]][1].append((kind, i))
    used = {p for pts, _ in groups for p in pts}
    T = [key for key in points if key in used]
    z_t = 1
    for key in T:
        z_t = z_t * (u - points[key]) % R
    terms, c_total, G = [], 0, len(groups)
    for gi, (pts, items) in enumerate(groups):
        zi = 1
        for key in T:
            if key not in pts:
                zi = zi * (u - points[key]) % R
        a = pow(v, G - 1 - gi, R) * zi % R
        m = len(items)
        for j, (kind, i) in enumerate(items):  # Horner in yy, the first item highest
            terms.append((commits[kind][i], a * pow(yy, m - 1 - j, R) % R))
        riu = 0
        for pt in pts:
            fold = 0
            for kind, i in items:
                fold = (fold * yy + evals[pt][kind][i]) % R
            num = den = 1
            for qt in pts:
                if qt != pt:
                    num = num * (u - points[qt]) % R
                    den = den * (points[pt] - points[qt]) % R
            riu = (riu + fold * num % R * pow(den, -1, R)) % R
        c_total = (c_total + a * riu) % R
    terms += [(G1, -c_total % R), (h_c, -z_t % R)]
    big_l = lincomb(terms)
    if not on_curve(q_c) or mul(q_c, (tau - u) % R) != big_l:
        return False, "opening"
    return True, ""

