"""Proof creation — replacement for halo2-axiom's create_proof.

Counterpart of `paillier_halo2_tpu/plonk/prover.py:1`, with the SHPLONK
and the GWC multi-open (the proving key's `vk.multiopen`). Per-column iNTT +
MSM commitments, permuted lookups, grand products, the quotient on the
extended coset, and the multi-open all run as batched limb-tensor
arithmetic on the proving key's device; transcript hashing and
scalar plumbing run on the host. Proof bytes equal the JAX package's for the
same SRS, circuit and blinding seed.

Constraint order (the y-combination; verifier.py must match exactly):
  1. per advice column c: q_c * (a_c + a_c(w) * a_c(w2) - a_c(w3))
  2. l_0 * (Z_0 - 1)
  3. per perm chunk i: active * [Z_i(wX) * prod(col + beta*sigma + gamma)
                               - Z_i(X) * prod(col + beta*id + gamma)]
  4. per chunk i>0: l_0 * (Z_i - Z_{i-1}(w^u X))
  5. l_u * (Z_last - 1)
  6. per lookup column:
     a. l_0 * (Zl - 1)
     b. l_u * (Zl - 1)
     c. active * [Zl(wX)*(A'+beta)(S'+gamma) - Zl(X)*(A+beta)(S+gamma)]
     d. active * (A'-S') * (A' - A'(w^-1 X))
     e. l_0 * (A' - S')

Slab widths come from the device's free memory (`torch.cuda.mem_get_info`)
in place of the JAX package's HBM knobs; slabbing never changes a value.

Self-checks (`create_proof(..., checks=)`, in place of the JAX package's
`PAILLIER_TPU_SELFCHECK`, `prover.py:47-60`): `"closing"` (the default)
reads back whether the permutation and lookup grand products close, one
readback each, so an unsatisfied witness raises before a proof is made;
`"all"` adds the three algebraic checks of the JAX package, each printing a
`[selfcheck]` line: the quotient's degree tail (`_check_degree_tail`), the
GWC fold and division identity per opening set (`_check_gwc_set`) and
SHPLONK's L(u) == 0 (`_check_shplonk_l`); `"none"` reads back nothing. A
failed check raises ValueError. No check writes to the transcript, so the
proof bytes do not depend on the level.
"""
from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from ..ff import field as f
from ..ff import host
from ..gadgets.context import VirtualTable
from ..poly import ops
from ..utils.trace import PhaseTimer, profile_section
from .keygen import (
    EXTENDED_RATE_BITS,
    ProvingKey,
    check_multiopen,
    delta_powers_dev,
    omega_powers_dev,
)
from .kzg import commit_many
from .layout import instance_column, lookup_columns, witness_columns
from .multiopen import KINDS, shplonk_groups
from .transcript import TranscriptWriter

P = host.FR_MOD
SPEC = f.FR
N_LIMBS = 8
CHECK_LEVELS = ("none", "closing", "all")
GWC_CHECK_POINT = 0x1234567  # the JAX package's xi for the division identity (`prover.py:1019`)

# Device bytes one lane of a batched NTT column may hold at peak: the limb
# tensor plus the int64 temporaries of the plain add/sub chains.
_LANE_BYTES = 1024
_CPU_BUDGET = 2 << 30


def column_slab(device, n: int) -> int:
    """Columns of width n that one batched transform may take at once: half
    the device's free memory (a fixed 2 GiB on the CPU) over the per-column
    peak."""
    device = torch.device(device)
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 2
    else:
        budget = _CPU_BUDGET
    return max(1, budget // (_LANE_BYTES * n))


def _mont(vals, device) -> torch.Tensor:
    """(8, len) Montgomery limbs of host Fr values."""
    return f.pack_ints([v % P * SPEC.r_mod_p % P for v in vals], device)


def _blind_tail(vals: np.ndarray, usable: int, seed: bytes, tag: bytes) -> np.ndarray:
    out = vals.copy()
    for r in range(usable, len(out)):
        h = hashlib.blake2b(seed + tag + r.to_bytes(4, "little")).digest()
        out[r] = int.from_bytes(h, "little") % P
    return out


def _blind_rows(seed: bytes, tag: bytes, count: int, usable: int, n: int) -> np.ndarray:
    """(count, n - usable - 1) blinding values for grand-product tails."""
    out = np.empty((count, n - usable - 1), dtype=object)
    for c in range(count):
        for r in range(usable + 1, n):
            h = hashlib.blake2b(seed + tag % c + r.to_bytes(4, "little")).digest()
            out[c, r - usable - 1] = int.from_bytes(h, "little") % P
    return out


def _permuted_lookup(a_active: np.ndarray, lookup_bits: int, usable: int):
    """halo2 permuted-lookup pair over the active region: A' = sorted A; at
    every first occurrence S'[i] = A'[i]; the holes take the unused table
    values ascending, then the table's surplus zeros."""
    a_sorted = np.sort(np.asarray([int(v) for v in a_active], dtype=np.int64))
    n_table = 1 << lookup_bits
    if len(a_sorted) and (a_sorted[0] < 0 or a_sorted[-1] >= n_table):
        raise ValueError("lookup input outside table range")
    first = np.empty(usable, dtype=bool)
    first[0] = True
    np.not_equal(a_sorted[1:], a_sorted[:-1], out=first[1:])
    s_sorted = np.where(first, a_sorted, np.int64(-1))
    leftovers = np.setdiff1d(np.arange(n_table, dtype=np.int64), a_sorted[first])
    holes = np.nonzero(~first)[0]
    fill = np.zeros(len(holes), dtype=np.int64)
    fill[: len(leftovers)] = leftovers
    s_sorted[holes] = fill
    return a_sorted, s_sorted


@functools.lru_cache(maxsize=8)
def _zh_inv_dev(k: int, k_ext: int, device: str) -> torch.Tensor:
    """1/Z_H on the extended coset: a period-`rate` pattern, (8, n_ext)."""
    n = 1 << k
    rate = 1 << (k_ext - k)
    gn = pow(host.FR_GENERATOR, n, P)
    w_ext = host.root_of_unity(k_ext)
    pattern = [pow((gn * pow(w_ext, n * i, P) - 1) % P, P - 2, P) for i in range(rate)]
    return _mont(pattern, device).repeat(1, n)


def _rot(e: torch.Tensor, s: int, rate: int) -> torch.Tensor:
    return torch.roll(e, -s * rate, dims=-1)


def _mul(a, b):
    return f.mont_mul(SPEC, a, b)


def _add(a, b):
    return f.add(SPEC, a, b)


def _sub(a, b):
    return f.sub(SPEC, a, b)


def _fold(acc, cstack, ypow, ym):
    """acc * y^m + sum_i C_i * y^(m-1-i) over the middle axis of cstack."""
    return _add(_mul(acc, ym), ops.sum_axis(_mul(cstack, ypow), 1))


def _fused_gates(k, k_ext, q_stack, a_stack, acc, ypow, ym):
    """Gate-constraint slab (`prover.py:187-201`): extended-coset NTTs,
    q * (a + a(w) a(w2) - a(w3)) and the y-Horner fold into acc."""
    rate = 1 << (k_ext - k)
    q_ext = ops.extended_coset_evals(q_stack, k, k_ext)
    a_ext = ops.extended_coset_evals(a_stack, k, k_ext)
    gate = _add(a_ext, _mul(_rot(a_ext, 1, rate), _rot(a_ext, 2, rate)))
    gate = _sub(gate, _rot(a_ext, 3, rate))
    return _fold(acc, _mul(q_ext, gate), ypow, ym)


def _fused_perm_chunks(k, k_ext, pcs, col_stack, sig_stack, id_vals, zslab_ext, act_ext,
                       beta_m, gamma_m, one_m, acc, ypow, ym):
    """Permutation chunk-update slab (`prover.py:204-231`):
    active * [Z(wX) prod(col + b*sigma + g) - Z(X) prod(col + b*id + g)]."""
    rate = 1 << (k_ext - k)
    col_e = ops.extended_coset_evals(col_stack, k, k_ext)
    sig_e = ops.extended_coset_evals(sig_stack, k, k_ext)
    id_e = ops.extended_coset_evals(ops.coeffs_of(id_vals, k), k, k_ext)
    b3, g3 = beta_m[:, None, :], gamma_m[:, None, :]
    fs = _add(col_e, _add(_mul(b3, sig_e), g3))
    fi = _add(col_e, _add(_mul(b3, id_e), g3))
    del col_e, sig_e, id_e
    if pcs:  # pad an odd column count with multiplicative-identity factors
        ones_pad = one_m[:, None, :].expand(N_LIMBS, pcs, fs.shape[-1])
        fs = torch.cat([fs, ones_pad], dim=1)
        fi = torch.cat([fi, ones_pad], dim=1)
    lhs = _mul(_rot(zslab_ext, 1, rate), _mul(fs[:, 0::2], fs[:, 1::2]))
    rhs = _mul(zslab_ext, _mul(fi[:, 0::2], fi[:, 1::2]))
    return _fold(acc, _mul(act_ext[:, None], _sub(lhs, rhs)), ypow, ym)


def _fused_lookups(k, k_ext, zl_ext, lk_stack, ap_stack, sp_stack, table_ext, l0_ext, lu_ext,
                   act_ext, beta_m, gamma_m, one_m, acc, ypow, ym):
    """Lookup constraint slab (a..e per column, `prover.py:234-267`)."""
    rate = 1 << (k_ext - k)
    g = lk_stack.shape[1]
    n_ext = table_ext.shape[-1]
    lk_ext = ops.extended_coset_evals(lk_stack, k, k_ext)
    ap_ext = ops.extended_coset_evals(ap_stack, k, k_ext)
    sp_ext = ops.extended_coset_evals(sp_stack, k, k_ext)
    b3, g3 = beta_m[:, None, :], gamma_m[:, None, :]
    one3 = one_m[:, None, :]
    ca = _mul(l0_ext[:, None], _sub(zl_ext, one3))
    cb = _mul(lu_ext[:, None], _sub(zl_ext, one3))
    lhs_l = _mul(_rot(zl_ext, 1, rate), _mul(_add(ap_ext, b3), _add(sp_ext, g3)))
    rhs_l = _mul(zl_ext, _mul(_add(lk_ext, b3), _add(table_ext[:, None], g3)))
    cc = _mul(act_ext[:, None], _sub(lhs_l, rhs_l))
    d1 = _sub(ap_ext, sp_ext)
    d2 = _sub(ap_ext, _rot(ap_ext, -1, rate))
    cd = _mul(act_ext[:, None], _mul(d1, d2))
    ce = _mul(l0_ext[:, None], d1)
    cstack = torch.stack([ca, cb, cc, cd, ce], dim=2).reshape(N_LIMBS, g * 5, n_ext)
    return _fold(acc, cstack, ypow, ym)


def _check_degree_tail(t_coeffs: torch.Tensor, n_pieces: int, n: int) -> None:
    """Every coefficient of t(X) past n_pieces * n is zero: a nonzero one
    means a constraint exceeds the degree bound the pieces assume, and the
    proof would be unsound. Counted on the device, one readback."""
    tail = t_coeffs[:, n_pieces * n :]
    n_bad = int((tail != 0).any(dim=0).sum())
    print(f"[selfcheck] t degree tail: {n_bad}/{tail.shape[1]} nonzero coeffs past "
          f"{n_pieces}n {'** DEGREE OVERFLOW **' if n_bad else '(ok)'}", flush=True)
    if n_bad:
        raise ValueError(f"quotient degree overflow: {n_bad} nonzero t(X) coefficients past "
                         f"{n_pieces}*n; a constraint exceeds the assumed degree bound")


def _check_shplonk_l(big_l: torch.Tensor, u: int) -> None:
    """SHPLONK's linearisation polynomial L vanishes at the challenge u."""
    lu = ops.eval_at(big_l, u)
    print(f"[selfcheck] shplonk L(u) == 0: {lu == 0}", flush=True)
    if lu != 0:
        raise ValueError("SHPLONK self-check failed: L(u) != 0")


class _Evaluator:
    """One-off evaluations at host points for the GWC self-check
    (`prover.py:270-286`), each point's power row built once on the
    device."""

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        self._powers: dict[int, torch.Tensor] = {}

    def eval(self, coeffs: torch.Tensor, x: int) -> int:
        if x not in self._powers:
            self._powers[x] = ops.powers_dev([x], self.n, self.device)[:, 0]
        pw = self._powers[x][:, : coeffs.shape[1]]
        return ops.from_device_mont(ops._sum_reduce(_mul(coeffs, pw)))[0]


def _check_gwc_set(ev: _Evaluator, key: str, folded: torch.Tensor, z: int, evals: list[int],
                   nu: int) -> None:
    """One GWC opening set: the nu-fold of its polynomials, evaluated at z,
    equals the same fold of the evaluations written to the transcript, and
    its quotient (f(X) - f(z)) / (X - z) satisfies the division identity at
    GWC_CHECK_POINT (`prover.py:996-1031`)."""
    fz = ev.eval(folded, z)
    v_fold = 0
    for e in evals:
        v_fold = (v_fold * nu + e) % P
    xi = GWC_CHECK_POINT
    lhs = (ev.eval(folded, xi) - fz) * pow(xi - z, P - 2, P) % P
    rhs = ev.eval(ops.synthetic_divide(folded, z), xi)
    print(f"[selfcheck] open@{key}: fold==f(z): {fz == v_fold}; division identity: {lhs == rhs}",
          flush=True)
    if fz != v_fold or lhs != rhs:
        raise ValueError(f"GWC self-check failed at {key}: fold==f(z) {fz == v_fold}, "
                         f"division identity {lhs == rhs}")


def create_proof(pk: ProvingKey, table: VirtualTable, blinding_seed: bytes | None = None,
                 timer: PhaseTimer | None = None, profile_dir: str | None = None,
                 checks: str = "closing") -> bytes:
    """blinding_seed=None (the default) draws fresh randomness (os.urandom),
    so proofs are zero-knowledge; an explicit seed makes them deterministic
    (fixtures, tests). With `profile_dir` the proof runs under
    `profile_section("create_proof", profile_dir)`, which writes a trace
    there. `checks` is one of CHECK_LEVELS (module docstring); the bytes
    are the same at every level."""
    if checks not in CHECK_LEVELS:
        raise ValueError(f"unknown self-check level {checks!r}; one of {CHECK_LEVELS}")
    if blinding_seed is None:
        blinding_seed = os.urandom(32)
    timer = timer or PhaseTimer("prover")
    with torch.no_grad(), profile_section("create_proof", profile_dir):
        return _create_proof_inner(pk, table, blinding_seed, timer.mark, checks)


def _create_proof_inner(pk: ProvingKey, table: VirtualTable, blinding_seed: bytes, _mark,
                        checks: str) -> bytes:
    closing, heavy = checks != "none", checks == "all"
    vk = pk.vk
    check_multiopen(vk.multiopen)
    dev = pk.srs.device
    k, n, usable = vk.k, vk.n, vk.usable
    k_ext = k + EXTENDED_RATE_BITS
    rate = 1 << EXTENDED_RATE_BITS
    n_ext = n << EXTENDED_RATE_BITS
    na, nl = vk.num_advice, vk.num_lookup_advice
    layout = pk.layout
    tr = TranscriptWriter()
    for c in vk.fixed_commitments():
        tr.common_point(c)
    # public inputs bind the statement: absorbed, not written
    for v in (table.public_values() if vk.num_instance else []):
        tr.common_scalar(v)

    # ---- 1. advice + lookup-advice columns ------------------------------------
    adv_vals = witness_columns(table, layout, blinding_seed)
    lk_vals = lookup_columns(table, layout)
    for i in range(nl):
        lk_vals[i] = _blind_tail(lk_vals[i], usable, blinding_seed, b"lk%d" % i)
    col_stack = ops.coeffs_of(
        ops.to_device_mont(np.concatenate([adv_vals, lk_vals]) if nl else adv_vals, dev), k
    )
    adv_coeffs = [col_stack[:, c] for c in range(na)]
    lk_coeffs = [col_stack[:, na + i] for i in range(nl)]
    for pt in commit_many(pk.srs, adv_coeffs + lk_coeffs):
        tr.write_point(pt)
    _mark("advice committed")

    # ---- 2. permuted lookup pairs ----------------------------------------------
    ap_vals, sp_vals = [], []
    for i in range(nl):
        a_s, s_s = _permuted_lookup(lk_vals[i][:usable], vk.lookup_bits, usable)
        apv = np.zeros(n, dtype=object)
        spv = np.zeros(n, dtype=object)
        apv[:usable] = a_s.astype(object)
        spv[:usable] = s_s.astype(object)
        ap_vals.append(_blind_tail(apv, usable, blinding_seed, b"ap%d" % i))
        sp_vals.append(_blind_tail(spv, usable, blinding_seed, b"sp%d" % i))
    ap_coeffs, sp_coeffs = [], []
    if nl:
        asp_stack = ops.coeffs_of(ops.to_device_mont(np.stack(ap_vals + sp_vals), dev), k)
        ap_coeffs = [asp_stack[:, i] for i in range(nl)]
        sp_coeffs = [asp_stack[:, nl + i] for i in range(nl)]
    for pt in commit_many(pk.srs, ap_coeffs + sp_coeffs):
        tr.write_point(pt)
    _mark("permuted lookups committed")

    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    beta_m = ops.fr_digits_mont(beta, dev).reshape(-1, 1)
    gamma_m = ops.fr_digits_mont(gamma, dev).reshape(-1, 1)
    one_m = SPEC.limbs("one_mont", dev).reshape(-1, 1)

    # ---- 3. permutation grand products -------------------------------------------
    # Permutation column j: advice j (j < na), lookup advice (na <= j < na+nl),
    # the fixed constant column (j = na+nl), then the instance column.
    if vk.num_instance:
        inst_coeffs = ops.coeffs_of(ops.to_device_mont(instance_column(table, layout), dev), k)

    def perm_col_coeffs(j: int) -> torch.Tensor:
        if j < na:
            return adv_coeffs[j]
        if j < na + nl:
            return lk_coeffs[j - na]
        if j == na + nl:
            return pk.fixed_const_coeffs
        return inst_coeffs

    npc = vk.n_perm_cols
    act_dev = torch.arange(n, device=dev) < usable
    b3, g3 = beta_m[:, None, :], gamma_m[:, None, :]
    omega_row = omega_powers_dev(k, str(dev))
    delta_all = delta_powers_dev(npc, str(dev))

    def id_cols_dev(cols: list[int]) -> torch.Tensor:
        return _mul(delta_all[:, cols][:, :, None], omega_row)

    def sigma_cols_dev(cols: list[int]) -> torch.Tensor:
        return ops.values_of(torch.stack([pk.sigma_coeffs[j] for j in cols], dim=1), k)

    n_chunks = len(vk.perm_chunks)
    QG = column_slab(dev, n_ext)  # extended-domain columns per slab
    GROUP = max(1, QG // 8)  # perm chunks per slab: ~8 extended columns each
    pref_slabs, ends = [], []
    for c0 in range(0, n_chunks, GROUP):
        c1 = min(c0 + GROUP, n_chunks)
        cols = list(range(2 * c0, min(2 * c1, npc)))
        pcd = ops.values_of(torch.stack([perm_col_coeffs(j) for j in cols], dim=1), k)
        num_f = _add(pcd, _add(_mul(b3, id_cols_dev(cols)), g3))
        den_f = _add(pcd, _add(_mul(b3, sigma_cols_dev(cols)), g3))
        pc = (c1 - c0) * 2 - len(cols)  # pad to whole chunks
        if pc:
            pad_ones = one_m[:, None, :].expand(N_LIMBS, pc, n)
            num_f = torch.cat([num_f, pad_ones], dim=1)
            den_f = torch.cat([den_f, pad_ones], dim=1)
        num_c = _mul(num_f[:, 0::2], num_f[:, 1::2])  # (8, C, n)
        den_c = _mul(den_f[:, 0::2], den_f[:, 1::2])
        frac = _mul(num_c, ops.batch_inverse(den_c))
        frac = torch.where(act_dev, frac, one_m[:, None, :])
        pref = ops.prefix_product(frac)  # inclusive along rows
        pref_slabs.append(pref)
        ends.append(pref[:, :, usable - 1])
    # chain starts: starts[c] = prod_{c' < c} ends[c']
    pp_ends = ops.prefix_product(torch.cat(ends, dim=1))
    starts = torch.cat([one_m, pp_ends[:, :-1]], dim=1)
    if closing and ops.from_device_mont(pp_ends[:, -1:])[0] != 1:
        raise ValueError("permutation product does not close (copy constraints unsatisfied?)")
    zp_blind_dev = ops.to_device_mont(_blind_rows(blinding_seed, b"zp%d", n_chunks, usable, n), dev)
    zp_parts = []
    for si, c0 in enumerate(range(0, n_chunks, GROUP)):
        c1 = min(c0 + GROUP, n_chunks)
        pref = pref_slabs[si]
        shifted = torch.cat([one_m[:, None, :].expand(N_LIMBS, c1 - c0, 1), pref[:, :, :-1]], dim=2)
        z_slab = _mul(shifted, starts[:, c0:c1, None])  # z[c, usable] = end_c * start_c
        z_slab[:, :, usable + 1 :] = zp_blind_dev[:, c0:c1]
        zp_parts.append(ops.coeffs_of(z_slab, k))
    del pref_slabs, ends, pp_ends, zp_blind_dev
    zp_stack = torch.cat(zp_parts, dim=1)
    zp_coeffs = [zp_stack[:, c] for c in range(n_chunks)]
    _mark("perm Z computed")

    # ---- 4. lookup grand products (batched over lookup columns) -----------------
    table_dev = pk.__dict__.get("_table_mont_dev")
    if table_dev is None:
        table_dev = pk.__dict__["_table_mont_dev"] = ops.to_device_mont(pk.table_values, dev)
    zl_coeffs = []
    if nl:
        ap_dev = ops.values_of(torch.stack(ap_coeffs, dim=1), k)
        sp_dev = ops.values_of(torch.stack(sp_coeffs, dim=1), k)
        lk_dev = ops.values_of(torch.stack(lk_coeffs, dim=1), k)
        num_l = _mul(_add(lk_dev, b3), _add(table_dev[:, None, :], g3))
        den_l = _mul(_add(ap_dev, b3), _add(sp_dev, g3))
        frac_l = _mul(num_l, ops.batch_inverse(den_l))
        frac_l = torch.where(act_dev, frac_l, one_m[:, None, :])
        pref_l = ops.prefix_product(frac_l)
        if closing and any(e != 1 for e in ops.from_device_mont(pref_l[:, :, usable - 1 : usable])):
            raise ValueError("lookup product does not close (lookup unsatisfied?)")
        zl_all = torch.cat([one_m[:, None, :].expand(N_LIMBS, nl, 1), pref_l[:, :, :-1]], dim=2)
        zl_all[:, :, usable + 1 :] = ops.to_device_mont(
            _blind_rows(blinding_seed, b"zl%d", nl, usable, n), dev
        )
        zl_stack = ops.coeffs_of(zl_all, k)
        zl_coeffs = [zl_stack[:, i] for i in range(nl)]
        del num_l, den_l, frac_l, pref_l, zl_all, ap_dev, sp_dev, lk_dev
    for pt in commit_many(pk.srs, zp_coeffs + zl_coeffs):
        tr.write_point(pt)
    _mark("grand products committed")
    y = tr.squeeze_challenge()

    # ---- 5. quotient on the extended coset ----------------------------------------
    def ext(coeffs):
        return ops.extended_coset_evals(coeffs, k, k_ext)

    def ypow_ym(m):
        ypow = _mont([pow(y, m - 1 - i, P) for i in range(m)], dev)[:, :, None]
        return ypow, _mont([pow(y, m, P)], dev)

    acc = torch.zeros((N_LIMBS, n_ext), dtype=torch.int32, device=dev)

    def emit_many(cstack):
        """cstack: (8, m, n_ext), constraints in emission order."""
        nonlocal acc
        acc = _fold(acc, cstack, *ypow_ym(cstack.shape[1]))

    # 1. gates, in column slabs (two extended NTTs per column)
    QG_F = max(1, QG // 2)
    for a0 in range(0, na, QG_F):
        a1 = min(a0 + QG_F, na)
        acc = _fused_gates(
            k, k_ext, torch.stack(pk.q_coeffs[a0:a1], dim=1),
            torch.stack(adv_coeffs[a0:a1], dim=1), acc, *ypow_ym(a1 - a0),
        )
    _mark("gate constraints emitted")
    l0_ext = ext(pk.l0_coeffs)
    lu_ext = ext(pk.lu_coeffs)
    act_ext = ext(pk.active_coeffs)

    def zp_ext_slab(c0: int, c1: int) -> torch.Tensor:
        return ext(zp_stack[:, c0:c1])

    # 2. l_0 * (Z_0 - 1)
    emit_many(_mul(l0_ext, _sub(zp_ext_slab(0, 1)[:, 0], one_m))[:, None])
    # 3. chunk updates
    for c0 in range(0, n_chunks, GROUP):
        c1 = min(c0 + GROUP, n_chunks)
        cols = list(range(2 * c0, min(2 * c1, npc)))
        acc = _fused_perm_chunks(
            k, k_ext, (c1 - c0) * 2 - len(cols),
            torch.stack([perm_col_coeffs(j) for j in cols], dim=1),
            torch.stack([pk.sigma_coeffs[j] for j in cols], dim=1),
            id_cols_dev(cols), zp_ext_slab(c0, c1), act_ext, beta_m, gamma_m, one_m,
            acc, *ypow_ym(c1 - c0),
        )
    # 4. chains: l_0 * (Z_i - Z_{i-1}(w^u X))
    for c0 in range(0, n_chunks - 1, GROUP):
        c1 = min(c0 + GROUP, n_chunks - 1)
        zslab_w = zp_ext_slab(c0, c1 + 1)  # chunks c0..c1 inclusive
        chain = _sub(zslab_w[:, 1:], _rot(zslab_w[:, :-1], usable, rate))
        emit_many(_mul(l0_ext[:, None], chain))
        del chain, zslab_w
    # 5. closing: l_u * (Z_last - 1)
    emit_many(_mul(lu_ext, _sub(zp_ext_slab(n_chunks - 1, n_chunks)[:, 0], one_m))[:, None])
    _mark("perm constraints emitted")
    # 6. lookups, in column slabs (five constraints per column)
    if nl:
        table_ext = ext(pk.table_coeffs)
        LG = max(1, QG // 12)
        for i0 in range(0, nl, LG):
            i1 = min(i0 + LG, nl)
            acc = _fused_lookups(
                k, k_ext, ext(zl_stack[:, i0:i1]),
                torch.stack(lk_coeffs[i0:i1], dim=1),
                torch.stack(ap_coeffs[i0:i1], dim=1),
                torch.stack(sp_coeffs[i0:i1], dim=1),
                table_ext, l0_ext, lu_ext, act_ext, beta_m, gamma_m, one_m,
                acc, *ypow_ym((i1 - i0) * 5),
            )
        del table_ext

    t_ext = _mul(acc, _zh_inv_dev(k, k_ext, str(dev)))
    _mark("quotient divided")
    t_coeffs = ops.coeffs_from_extended(t_ext, k, k_ext)
    n_pieces = 3  # max constraint degree 4 -> deg(t) <= 3n - 4
    if heavy:
        _check_degree_tail(t_coeffs, n_pieces, n)
    t_pieces = [t_coeffs[:, i * n : (i + 1) * n] for i in range(n_pieces)]
    for pt in commit_many(pk.srs, t_pieces):
        tr.write_point(pt)
    _mark("quotient committed")

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
    nz = n_chunks
    opening_sets = [
        ("x", adv_coeffs + lk_coeffs + pk.q_coeffs + [pk.fixed_const_coeffs, pk.table_coeffs]
         + pk.sigma_coeffs + zp_coeffs + zl_coeffs + ap_coeffs + sp_coeffs + t_pieces),
        ("wx", adv_coeffs + zp_coeffs + zl_coeffs),
        ("w2x", adv_coeffs),
        ("w3x", adv_coeffs),
        ("winvx", ap_coeffs),
        ("wux", zp_coeffs[:-1] if nz > 1 else []),
    ]

    # ---- evals: every (point, poly) pair batched, one readback ----------------
    zs = [points[key] for key, _ in opening_sets]
    zinvs = [pow(z, P - 2, P) for z in zs]
    pw = ops.powers_dev(zs, n, dev)  # (8, 6, n)
    pw_inv = ops.powers_dev(zinvs, n, dev)
    EV_SLAB = max(4 * QG, 8)
    ev_parts = []
    for si, (key, polys) in enumerate(opening_sets):
        row = pw[:, si : si + 1, :]
        for c0 in range(0, len(polys), EV_SLAB):
            stacked = torch.stack(list(polys[c0 : c0 + EV_SLAB]), dim=1)
            ev_parts.append(ops.sum_axis(_mul(stacked, row), 2))
    all_ev_flat = ops.from_device_mont(torch.cat(ev_parts, dim=1))
    all_evals: dict[str, list[int]] = {}
    pos = 0
    for key, polys in opening_sets:
        evs = all_ev_flat[pos : pos + len(polys)]
        pos += len(polys)
        all_evals[key] = evs
        for e in evs:
            tr.write_scalar(e)
    _mark("evals written")

    def fold_slabbed(polys, coefs_mont):
        """sum_j coefs[j] * polys[j]; coefs (8, m, 1) Montgomery."""
        acc_c = None
        for c0 in range(0, len(polys), EV_SLAB):
            part = ops.sum_axis(
                _mul(torch.stack(list(polys[c0 : c0 + EV_SLAB]), dim=1),
                     coefs_mont[:, c0 : c0 + EV_SLAB]),
                1,
            )
            acc_c = part if acc_c is None else _add(acc_c, part)
        return acc_c

    zeros1 = torch.zeros((N_LIMBS, 1), dtype=torch.int32, device=dev)

    def syn_div_rows(arr, zrow, zinvrow, zinv: int):
        """(f(X) - f(z)) / (X - z) from precomputed power rows."""
        incl = ops._suffix_sum(_mul(arr, zrow))
        s = torch.cat([incl[:, 1:], zeros1], dim=1)
        return _mul(_mul(s, zinvrow), _mont([zinv], dev))

    if vk.multiopen == "gwc":
        ev = _Evaluator(n, dev) if heavy else None
        _gwc_open(pk, tr, opening_sets, all_evals, points, pw, pw_inv, zinvs, fold_slabbed, ev)
    else:
        _shplonk_open(
            pk, tr, opening_sets, all_evals, points, pw, pw_inv, zinvs, fold_slabbed,
            syn_div_rows, n, na, nl, nz,
            {
                "adv": adv_coeffs, "lk": lk_coeffs, "q": pk.q_coeffs,
                "fc": [pk.fixed_const_coeffs], "table": [pk.table_coeffs],
                "sigma": pk.sigma_coeffs, "zp": zp_coeffs, "zl": zl_coeffs,
                "ap": ap_coeffs, "sp": sp_coeffs, "t": t_pieces,
            },
            heavy,
        )
    _mark("multiopen done")
    return tr.finalize()


def _gwc_open(pk, tr, opening_sets, all_evals, points, pw, pw_inv, zinvs, fold_slabbed,
              ev: _Evaluator | None):
    """GWC multi-open (`prover.py:990-1048`): each non-empty opening set
    folded by powers of nu (first poly highest), then every W quotient in
    one batched synthetic division, q_i = z^-(i+1) * suffix_sum(c_j z^j)_{i+1}
    over the power rows, and the W points in one commit_many. With an
    evaluator each fold is self-checked (`_check_gwc_set`)."""
    dev = pw.device
    nu = tr.squeeze_challenge()
    acc_list, acc_rows = [], []
    for si, (key, polys) in enumerate(opening_sets):
        if not polys:
            continue
        m = len(polys)
        nupow = _mont([pow(nu, m - 1 - i, P) for i in range(m)], dev)[:, :, None]
        acc_list.append(fold_slabbed(polys, nupow))
        acc_rows.append(si)
        if ev is not None:
            _check_gwc_set(ev, key, acc_list[-1], points[key], all_evals[key], nu)
    incl = ops._suffix_sum(_mul(torch.stack(acc_list, dim=1), pw[:, acc_rows]))
    del acc_list
    s = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], dim=-1)
    zinv_m = _mont([zinvs[si] for si in acc_rows], dev)[:, :, None]
    wq = _mul(_mul(s, pw_inv[:, acc_rows]), zinv_m)
    for pt in commit_many(pk.srs, [wq[:, i] for i in range(len(acc_rows))]):
        tr.write_point(pt)


def _shplonk_open(pk, tr, opening_sets, all_evals, points, pw, pw_inv, zinvs,
                  fold_slabbed, syn_div_rows, n, na, nl, nzp, polys_by_kind, heavy: bool):
    """SHPLONK (BDFG20) multi-open (`prover.py:288-401`); see
    plonk/multiopen.py for the protocol and the grouping shared with the
    verifier. Poly arithmetic runs on the device; the r_i(u) Lagrange terms
    and Z_T factors are host scalars. `heavy` checks L(u) == 0."""
    dev = pw.device
    npc = pk.vk.n_perm_cols
    groups = shplonk_groups(na, nl, npc, nzp, len(polys_by_kind["t"]))
    si_of = {key: i for i, (key, _) in enumerate(opening_sets)}

    emap: dict[tuple, int] = {}

    def fill(key, items):
        evs = all_evals[key]
        assert len(items) == len(evs), (key, len(items), len(evs))
        for it, e in zip(items, evs):
            emap[it + (key,)] = e

    fill("x", [(kind, i) for kind in KINDS for i in range(len(polys_by_kind[kind]))])
    fill("wx", [("adv", i) for i in range(na)] + [("zp", i) for i in range(nzp)]
         + [("zl", i) for i in range(nl)])
    fill("w2x", [("adv", i) for i in range(na)])
    fill("w3x", [("adv", i) for i in range(na)])
    fill("winvx", [("ap", i) for i in range(nl)])
    fill("wux", [("zp", i) for i in range(nzp - 1)] if nzp > 1 else [])

    y = tr.squeeze_challenge()
    v = tr.squeeze_challenge()

    F_list, r_evals = [], []
    h_acc = None
    G = len(groups)
    for gi, (pts, items) in enumerate(groups):
        m = len(items)
        ypow = _mont([pow(y, m - 1 - j, P) for j in range(m)], dev)[:, :, None]
        Fg = fold_slabbed([polys_by_kind[kind][i] for kind, i in items], ypow)
        F_list.append(Fg)
        re = {}
        for pt in pts:
            acc = 0
            for kind, i in items:
                acc = (acc * y + emap[(kind, i, pt)]) % P
            re[pt] = acc
        r_evals.append(re)
        hg = Fg
        for pt in pts:  # chained subtract-eval-and-divide == (F - r_i) / Z_S
            si = si_of[pt]
            hg = syn_div_rows(hg, pw[:, si], pw_inv[:, si], zinvs[si])
        term = _mul(hg, _mont([pow(v, G - 1 - gi, P)], dev))
        h_acc = term if h_acc is None else _add(h_acc, term)
    (h_pt,) = commit_many(pk.srs, [h_acc])
    tr.write_point(h_pt)
    u = tr.squeeze_challenge()

    # host scalars: Z_T(u), z_i = Z_{T \ S_i}(u), r_i(u), c = sum a_i r_i(u)
    used = set()
    for pts, _ in groups:
        used.update(pts)
    T = [key for key, _ in opening_sets if key in used]
    z_t = 1
    for key in T:
        z_t = z_t * (u - points[key]) % P
    a_list, c = [], 0
    for gi, (pts, items) in enumerate(groups):
        zi = 1
        for key in T:
            if key not in pts:
                zi = zi * (u - points[key]) % P
        riu = 0
        for pt in pts:  # Lagrange interpolation of the folded evals at u
            zt = points[pt]
            num, den = 1, 1
            for qt in pts:
                if qt == pt:
                    continue
                num = num * (u - points[qt]) % P
                den = den * (zt - points[qt]) % P
            riu = (riu + r_evals[gi][pt] * num % P * pow(den, P - 2, P)) % P
        a = pow(v, G - 1 - gi, P) * zi % P
        a_list.append(a)
        c = (c + a * riu) % P

    coefs = _mont(a_list + [(P - z_t) % P], dev)[:, :, None]
    big_l = fold_slabbed(F_list + [h_acc], coefs)
    big_l = torch.cat([_sub(big_l[:, :1], _mont([c], dev)), big_l[:, 1:]], dim=1)
    if heavy:
        _check_shplonk_l(big_l, u)
    u_inv = pow(u, P - 2, P)
    pwu = ops.powers_dev([u, u_inv], n, dev)
    q_poly = syn_div_rows(big_l, pwu[:, 0], pwu[:, 1], u_inv)
    (q_pt,) = commit_many(pk.srs, [q_poly])
    tr.write_point(q_pt)
