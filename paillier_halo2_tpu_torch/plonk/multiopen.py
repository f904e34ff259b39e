"""Multi-open scheme layout shared by prover and verifier.

SHPLONK (BDFG20) — the multi-open the halo2-axiom harness family defaults to
[dep, SURVEY.md section 7 step 7; upstream Cargo.toml:9] — groups the
committed polynomials by their ROTATION SET (the set of opening points) and
opens everything with TWO witness commitments (H, Q) instead of GWC's
one-per-point. This module pins the canonical poly ordering and the rotation
sets so both sides derive identical groups; the math lives in prover/verifier.

Protocol (after the evals are in the transcript):
  squeeze y  — folds polys within a rotation-set group:  F_i = sum_j y^pow f_j
  squeeze v  — folds the per-group quotients:            h   = sum_i v^pow h_i
               with h_i = (F_i - r_i) / Z_{S_i}, r_i the interpolation of
               F_i's claimed evals over S_i (computed implicitly by chained
               "subtract-eval-and-divide" synthetic divisions)
  write H = commit(h)
  squeeze u  — the final evaluation point
  L(X) = sum_i v^pow z_i (F_i(X) - r_i(u)) - Z_T(u) h(X),
         z_i = Z_{T \\ S_i}(u),  T = union of all points;  L(u) = 0
  write Q = commit(L / (X - u))
Verify: e(Q, [tau]_2) == e(L + u*Q, [1]_2) with [L] reconstructed from the
commitments and claimed evals.

Fold-power convention matches the GWC code: within any fold of m items the
FIRST item carries the highest power (Horner order), i.e. sum_j c^{m-1-j} x_j.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/plonk/multiopen.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

# Canonical per-poly kinds in transcript order (matches prover.py's at_x).
KINDS = ("adv", "lk", "q", "fc", "table", "sigma", "zp", "zl", "ap", "sp", "t")


def poly_point_set(kind: str, i: int, nz: int) -> tuple[str, ...]:
    """Rotation set (opening-point keys) of canonical poly (kind, i)."""
    if kind == "adv":
        return ("x", "wx", "w2x", "w3x")
    if kind == "zp":
        if nz > 1 and i < nz - 1:
            return ("x", "wx", "wux")
        return ("x", "wx")
    if kind == "zl":
        return ("x", "wx")
    if kind == "ap":
        return ("x", "winvx")
    # lk, q, fc, table, sigma, sp, t
    return ("x",)


def shplonk_groups(na: int, nl: int, npc: int, nz: int, n_pieces: int):
    """Ordered rotation-set groups.

    Returns a list of (point_keys, items) where items is a list of
    (kind, index) in canonical order; groups are ordered by first
    appearance of their rotation set in the canonical scan."""
    counts = {
        "adv": na, "lk": nl, "q": na, "fc": 1, "table": 1, "sigma": npc,
        "zp": nz, "zl": nl, "ap": nl, "sp": nl, "t": n_pieces,
    }
    groups: list[tuple[tuple[str, ...], list[tuple[str, int]]]] = []
    index: dict[tuple[str, ...], int] = {}
    for kind in KINDS:
        for i in range(counts[kind]):
            pts = poly_point_set(kind, i, nz)
            gi = index.get(pts)
            if gi is None:
                index[pts] = len(groups)
                groups.append((pts, []))
                gi = len(groups) - 1
            groups[gi][1].append((kind, i))
    return groups
