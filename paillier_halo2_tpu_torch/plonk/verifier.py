"""Proof verification — replacement for halo2-axiom's verify_proof
(SURVEY.md section 2.2; use-site upstream src/bench.rs:177). Pure host
arithmetic: transcript replay, the quotient identity at the challenge point
(closed forms for Lagrange/vanishing/id polynomials), and the final
2-pairing KZG check. Constraint order MUST mirror prover.py exactly.

Counterpart of `paillier_halo2_tpu/plonk/verifier.py:1`, SHPLONK and GWC
(the verifying key's `multiopen`). It runs on the host, with the native
engine's pairing when it builds.
"""
from __future__ import annotations

from ..ec import host as ech
from ..ec.pairing import pairing_check
from ..ff import host
from .keygen import DELTA, VerifyingKey, check_multiopen
from .srs import SRS
from .transcript import TranscriptReader

P = host.FR_MOD


def _lagrange_at(i: int, x: int, n: int, omega: int) -> int:
    """l_i(x) = omega^i (x^n - 1) / (n (x - omega^i))."""
    wi = pow(omega, i, P)
    num = wi * (pow(x, n, P) - 1) % P
    den = n * (x - wi) % P
    return num * pow(den, P - 2, P) % P


def _verify_shplonk(vk, srs, tr, commits, evals, points, na, nl, nz, npc, n_pieces):
    """SHPLONK (BDFG20) verification — mirrors prover._shplonk_open; see
    plonk/multiopen.py for the protocol and grouping contract.

    [L] = sum_i a_i C_i - c*G - Z_T(u)*H with a_i = v^pow * Z_{T\\S_i}(u),
    c = sum_i a_i r_i(u); accept iff e(Q, [tau]_2) == e(L + u*Q, [1]_2)."""
    from .multiopen import shplonk_groups

    y = tr.squeeze_challenge()
    v = tr.squeeze_challenge()
    h_commit = tr.read_point()
    u = tr.squeeze_challenge()
    q_commit = tr.read_point()
    tr.assert_consumed()

    groups = shplonk_groups(na, nl, npc, nz, n_pieces)
    # per-(kind, i) eval at a point key: evals[key][kind] lists follow the
    # same canonical order the prover used
    idx_of: dict[tuple, int] = {}
    for key, by_kind in evals.items():
        for kind, lst in by_kind.items():
            for i, e in enumerate(lst):
                idx_of[(kind, i, key)] = e

    used = set()
    for pts, _ in groups:
        used.update(pts)
    T = [key for key in points if key in used]
    z_t = 1
    for key in T:
        z_t = z_t * (u - points[key]) % P

    big_l = None
    c_total = 0
    G = len(groups)
    for gi, (pts, items) in enumerate(groups):
        # folded commitment and folded evals (Horner in y, first = highest)
        cm = None
        for kind, i in items:
            cm = ech.g1_add(ech.g1_mul(cm, y) if cm else None, commits[kind][i])
        zi = 1
        for key in T:
            if key not in pts:
                zi = zi * (u - points[key]) % P
        riu = 0
        for pt in pts:
            acc = 0
            for kind, i in items:
                acc = (acc * y + idx_of[(kind, i, pt)]) % P
            zt = points[pt]
            num, den = 1, 1
            for qt in pts:
                if qt == pt:
                    continue
                num = num * (u - points[qt]) % P
                den = den * (zt - points[qt]) % P
            riu = (riu + acc * num % P * pow(den, P - 2, P)) % P
        a = pow(v, G - 1 - gi, P) * zi % P
        c_total = (c_total + a * riu) % P
        big_l = ech.g1_add(big_l, ech.g1_mul(cm, a))
    big_l = ech.g1_add(big_l, ech.g1_neg(ech.g1_mul(ech.G1, c_total)))
    big_l = ech.g1_add(big_l, ech.g1_neg(ech.g1_mul(h_commit, z_t)))

    rhs = ech.g1_add(big_l, ech.g1_mul(q_commit, u))
    return pairing_check([(q_commit, srs.g2_tau), (ech.g1_neg(rhs), srs.g2_gen)])


def _verify_gwc(srs, tr, sets, points):
    """GWC verification — mirrors prover._gwc_open. `sets`: per opening
    point, its (commitment, eval) pairs in the prover's fold order. Reads
    one W per non-empty set; accepts iff
    e(sum u^j W_j, [tau]_2) == e(sum u^j (z_j W_j + F_j - v_j G), [1]_2)."""
    nu = tr.squeeze_challenge()
    sets = [(key, pairs) for key, pairs in sets if pairs]
    w_commits = [tr.read_point() for _ in sets]
    u = tr.squeeze_challenge()
    tr.assert_consumed()

    lhs_pt = rhs_pt = None
    upow = 1
    for (key, pairs), wc in zip(sets, w_commits):
        fj, vj = None, 0
        for cm, e in pairs:
            fj = ech.g1_add(ech.g1_mul(fj, nu) if fj else None, cm)
            vj = (vj * nu + e) % P
        term = ech.g1_add(ech.g1_mul(wc, points[key]), fj)
        term = ech.g1_add(term, ech.g1_neg(ech.g1_mul(ech.G1, vj)))
        lhs_pt = ech.g1_add(lhs_pt, ech.g1_mul(wc, upow))
        rhs_pt = ech.g1_add(rhs_pt, ech.g1_mul(term, upow))
        upow = upow * u % P
    return pairing_check([(lhs_pt, srs.g2_tau), (ech.g1_neg(rhs_pt), srs.g2_gen)])


def verify_proof(
    vk: VerifyingKey, srs: SRS, proof: bytes, instances: list[int] | None = None
) -> bool:
    """`instances`: the statement's public-input values (required iff the
    circuit exposes any — vk.num_instance == 1). The verifier re-derives the
    instance evaluation itself, so a proof only verifies against the exact
    public values the prover committed to. A key with an unknown multi-open
    scheme, or a call without the instances its circuit exposes, raises
    ValueError; a proof that fails any check returns False."""
    check_multiopen(vk.multiopen)
    if vk.num_instance and instances is None:
        raise ValueError("circuit exposes public inputs; pass instances=")
    try:
        return _verify(vk, srs, proof, instances)
    except (ValueError, AssertionError):
        return False


def _verify(
    vk: VerifyingKey, srs: SRS, proof: bytes, instances: list[int] | None = None
) -> bool:
    k, n, usable = vk.k, vk.n, vk.usable
    na, nl = vk.num_advice, vk.num_lookup_advice
    nz = len(vk.perm_chunks)
    npc = vk.n_perm_cols
    num_instance = vk.num_instance
    tr = TranscriptReader(proof)
    for c in vk.fixed_commitments():
        tr.common_point(c)
    if num_instance:
        for v in instances:
            tr.common_scalar(v)

    adv_commits = [tr.read_point() for _ in range(na)]
    lk_commits = [tr.read_point() for _ in range(nl)]
    ap_commits = [tr.read_point() for _ in range(nl)]
    sp_commits = [tr.read_point() for _ in range(nl)]
    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    zp_commits = [tr.read_point() for _ in range(nz)]
    zl_commits = [tr.read_point() for _ in range(nl)]
    y = tr.squeeze_challenge()
    n_pieces = 3
    t_commits = [tr.read_point() for _ in range(n_pieces)]
    x = tr.squeeze_challenge()

    w1 = host.root_of_unity(k)
    points = {
        "x": x,
        "wx": x * w1 % P,
        "w2x": x * pow(w1, 2, P) % P,
        "w3x": x * pow(w1, 3, P) % P,
        "winvx": x * pow(w1, P - 2, P) % P,
        "wux": x * pow(w1, usable, P) % P,
    }

    # ---- read evals (same nested order as the prover) ----------------------
    # at x: advice, lookup advice, q, fixed_const, table, sigmas, perm Zs,
    #       lookup Zs, A', S', t pieces
    counts_x = na + nl + na + 1 + 1 + npc + nz + nl + nl + nl + n_pieces
    evx = [tr.read_scalar() for _ in range(counts_x)]
    evwx = [tr.read_scalar() for _ in range(na + nz + nl)]
    evw2x = [tr.read_scalar() for _ in range(na)]
    evw3x = [tr.read_scalar() for _ in range(na)]
    evwinvx = [tr.read_scalar() for _ in range(nl)]
    evwux = [tr.read_scalar() for _ in range(nz - 1 if nz > 1 else 0)]

    idx = 0

    def take(m):
        nonlocal idx
        out = evx[idx : idx + m]
        idx += m
        return out

    adv_x = take(na)
    lk_x = take(nl)
    q_x = take(na)
    (fc_x,) = take(1)
    (table_x,) = take(1)
    sigma_x = take(npc)
    zp_x = take(nz)
    zl_x = take(nl)
    ap_x = take(nl)
    sp_x = take(nl)
    t_x = take(n_pieces)
    assert idx == counts_x

    adv_wx = evwx[:na]
    zp_wx = evwx[na : na + nz]
    zl_wx = evwx[na + nz :]
    ap_winvx = evwinvx

    # ---- closed-form fixed evals ------------------------------------------
    xn = pow(x, n, P)
    zh_x = (xn - 1) % P
    l0_x = _lagrange_at(0, x, n, w1)
    lu_x = _lagrange_at(usable, x, n, w1)
    active_x = (1 - sum(_lagrange_at(i, x, n, w1) for i in range(usable, n))) % P

    # ---- quotient identity at x (order mirrors prover.emit) ---------------
    constraints = []
    for c in range(na):
        constraints.append(
            q_x[c] * (adv_x[c] + adv_wx[c] * evw2x[c] - evw3x[c]) % P
        )
    constraints.append(l0_x * (zp_x[0] - 1) % P)

    def perm_col_eval(j: int) -> int:
        if j < na:
            return adv_x[j]
        if j < na + nl:
            return lk_x[j - na]
        if j == na + nl:
            return fc_x
        # instance column: the VERIFIER computes I(x) = sum_j pub_j l_j(x)
        # from the public values — this is what makes them public inputs.
        return (
            sum(v * _lagrange_at(i, x, n, w1) for i, v in enumerate(instances)) % P
        )

    for ci, chunk in enumerate(vk.perm_chunks):
        lhs = zp_wx[ci]
        rhs = zp_x[ci]
        for j in chunk:
            col = perm_col_eval(j)
            lhs = lhs * ((col + beta * sigma_x[j] + gamma) % P) % P
            idj = pow(DELTA, j, P) * x % P
            rhs = rhs * ((col + beta * idj + gamma) % P) % P
        constraints.append(active_x * (lhs - rhs) % P)
    for ci in range(1, nz):
        constraints.append(l0_x * (zp_x[ci] - evwux[ci - 1]) % P)
    constraints.append(lu_x * (zp_x[-1] - 1) % P)

    for i in range(nl):
        constraints.append(l0_x * (zl_x[i] - 1) % P)
        constraints.append(lu_x * (zl_x[i] - 1) % P)
        lhs = zl_wx[i] * ((ap_x[i] + beta) % P) % P * ((sp_x[i] + gamma) % P) % P
        rhs = zl_x[i] * ((lk_x[i] + beta) % P) % P * ((table_x + gamma) % P) % P
        constraints.append(active_x * (lhs - rhs) % P)
        d1 = (ap_x[i] - sp_x[i]) % P
        d2 = (ap_x[i] - ap_winvx[i]) % P
        constraints.append(active_x * d1 % P * d2 % P)
        constraints.append(l0_x * d1 % P)

    acc = 0
    for cst in constraints:
        acc = (acc * y + cst) % P

    t_eval = 0
    for j in range(n_pieces - 1, -1, -1):
        t_eval = (t_eval * xn + t_x[j]) % P
    if acc != t_eval * zh_x % P:
        return False

    if vk.multiopen == "gwc":
        return _verify_gwc(srs, tr, [
            ("x", list(zip(
                adv_commits + lk_commits + vk.q_commits
                + [vk.fixed_const_commit, vk.table_commit] + vk.sigma_commits + zp_commits
                + zl_commits + ap_commits + sp_commits + t_commits,
                evx))),
            ("wx", list(zip(adv_commits + zp_commits + zl_commits, evwx))),
            ("w2x", list(zip(adv_commits, evw2x))),
            ("w3x", list(zip(adv_commits, evw3x))),
            ("winvx", list(zip(ap_commits, ap_winvx))),
            ("wux", list(zip(zp_commits[: nz - 1], evwux))),
        ], points)
    return _verify_shplonk(
        vk, srs, tr,
        {
            "adv": adv_commits, "lk": lk_commits, "q": vk.q_commits,
            "fc": [vk.fixed_const_commit], "table": [vk.table_commit],
            "sigma": vk.sigma_commits, "zp": zp_commits, "zl": zl_commits,
            "ap": ap_commits, "sp": sp_commits, "t": t_commits,
        },
        {
            "x": {
                "adv": adv_x, "lk": lk_x, "q": q_x, "fc": [fc_x],
                "table": [table_x], "sigma": sigma_x, "zp": zp_x,
                "zl": zl_x, "ap": ap_x, "sp": sp_x, "t": t_x,
            },
            "wx": {"adv": adv_wx, "zp": zp_wx, "zl": zl_wx},
            "w2x": {"adv": evw2x},
            "w3x": {"adv": evw3x},
            "winvx": {"ap": ap_winvx},
            "wux": {"zp": evwux},
        },
        points, na, nl, nz, npc, n_pieces,
    )
