"""K2, K3, K4: batched G1 point additions — the wrappers around the CUDA
kernels of `csrc/g1_add.cu` and their plain PyTorch versions.

Counterpart of `paillier_halo2_tpu/ec/pallas_point.py:1`:

- `g1_jadd`          <- `padd_pallas` (:230), Jacobian + Jacobian (K2)
- `g1_madd`          <- `padd_mixed_pallas` (:265), Jacobian + affine (K3)
- `g1_madd_packed`   <- `padd_mixed_packed_pallas` (:309), the affine operand
                        as packed `(N, 16)` rows (K4)
- `window_sums`      <- K2's use in `_window_sums`
                        (`paillier_halo2_tpu/msm/pippenger.py:403-432`): the
                        MSM's bucket weighting, one launch for every row
- `fixed_base_comb`  <- K3's use in `_fixed_base_msm_kernel`
                        (`paillier_halo2_tpu/plonk/srs.py:90-112`): the SRS's
                        32-window comb, one launch for every scalar

Coordinates are `(8, N)` int32 Fq limb tensors in Montgomery form; `q_inf`
is an `(N,)` bool tensor. `nodouble=True` drops the doubling branch: a lane
whose operands coincide (or cancel) then degrades to Z == 0, never to a
wrong finite point. On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version. The plain versions follow
the kernels' formulas and select order exactly, through the plain field ops
(`mulmod.mont_mul_plain`), so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from ..ff import field as f
from ..ff.limbs16 import u64
from ..ff.mulmod import mont_mul_plain
from ..utils import kernels

SPEC = f.FQ
PACK_WORDS = 16  # 8 limbs of X, then 8 of Y
LAUNCHES = {"g1_jadd": 0, "g1_madd": 0, "g1_madd_packed": 0, "window_sums": 0,
            "fixed_base_comb": 0}
WINDOW_MAX_BUCKETS = 1210  # two buffers of B points in a block's shared memory
COMB_WINDOWS, COMB_ENTRIES = 32, 256  # 8-bit windows of a 256-bit scalar


# -- plain versions ------------------------------------------------------------


def _mul(a, b):
    return mont_mul_plain(SPEC, a, b)


def _add(a, b):
    return f.add(SPEC, a, b)


def _sub(a, b):
    return f.sub(SPEC, a, b)


def _sel(mask, a, b):
    return torch.where(mask, a, b)


def _dbl_plain(X1, Y1, Z1):
    """dbl-2009-l (a = 0), as pallas_point.py:98-112."""
    A = _mul(X1, X1)
    B = _mul(Y1, Y1)
    C = _mul(B, B)
    t = _add(X1, B)
    t = _mul(t, t)
    D = _sub(_sub(t, A), C)
    D = _add(D, D)
    E = _add(_add(A, A), A)
    F = _mul(E, E)
    Xd = _sub(F, _add(D, D))
    C8 = _add(C, C)
    C8 = _add(C8, C8)
    C8 = _add(C8, C8)
    Yd = _sub(_mul(E, _sub(D, Xd)), C8)
    YZ = _mul(Y1, Z1)
    Zd = _add(YZ, YZ)
    return Xd, Yd, Zd


def _one_zero(like):
    one = SPEC.limbs("one_mont", like.device)[:, None].expand_as(like)
    return one, torch.zeros_like(like)


def g1_jadd_plain(X1, Y1, Z1, X2, Y2, Z2, nodouble: bool = False):
    """K2's function: `_jacobian_add_full` (pallas_point.py:137-202)."""
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
    p_inf = f.is_zero(Z1)
    q_inf = f.is_zero(Z2)
    if not nodouble:
        Xd, Yd, Zd = _dbl_plain(X1, Y1, Z1)
        h_zero, r_zero = f.is_zero(h), f.is_zero(r)
        dbl = h_zero & r_zero
        X3, Y3, Z3 = _sel(dbl, Xd, X3), _sel(dbl, Yd, Y3), _sel(dbl, Zd, Z3)
        ann = h_zero & ~r_zero & ~p_inf & ~q_inf
        one, zero = _one_zero(X1)
        X3, Y3, Z3 = _sel(ann, one, X3), _sel(ann, one, Y3), _sel(ann, zero, Z3)
    X3, Y3, Z3 = _sel(q_inf, X1, X3), _sel(q_inf, Y1, Y3), _sel(q_inf, Z1, Z3)
    X3, Y3, Z3 = _sel(p_inf, X2, X3), _sel(p_inf, Y2, Y3), _sel(p_inf, Z2, Z3)
    return X3, Y3, Z3


def g1_madd_plain(X1, Y1, Z1, X2, Y2, q_inf, nodouble: bool = False):
    """K3's function: `_mixed_add_full` (pallas_point.py:65-134)."""
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
    p_inf = f.is_zero(Z1)
    one, zero = _one_zero(X1)
    if not nodouble:
        Xd, Yd, Zd = _dbl_plain(X1, Y1, Z1)
        h_zero, r_zero = f.is_zero(h), f.is_zero(r)
        dbl = h_zero & r_zero
        X3, Y3, Z3 = _sel(dbl, Xd, X3), _sel(dbl, Yd, Y3), _sel(dbl, Zd, Z3)
        ann = h_zero & ~r_zero & ~p_inf
        X3, Y3, Z3 = _sel(ann, one, X3), _sel(ann, one, Y3), _sel(ann, zero, Z3)
    X3, Y3 = _sel(p_inf, X2, X3), _sel(p_inf, Y2, Y3)
    Z3 = _sel(p_inf, _sel(q_inf, zero, one), Z3)
    X3, Y3, Z3 = _sel(q_inf, X1, X3), _sel(q_inf, Y1, Y3), _sel(q_inf, Z1, Z3)
    return X3, Y3, Z3


def unpack_rows(packed: torch.Tensor):
    """(N, 16) packed rows -> (X, Y) as (8, N) limb tensors."""
    t = packed.t()
    return t[:8].contiguous(), t[8:].contiguous()


def g1_madd_packed_plain(X1, Y1, Z1, packed, q_inf, nodouble: bool = False):
    """K4's function: K3 on the unpacked rows (pallas_point.py:292-305)."""
    X2, Y2 = unpack_rows(packed)
    return g1_madd_plain(X1, Y1, Z1, X2, Y2, q_inf, nodouble)


def window_sums_plain(X, Y, Z):
    """The window sums' function: `_window_sums` (JAX pippenger.py:401-432)
    on (8, rows, B) canonical Jacobian buckets, T_w = sum_b b * B_{w,b} by a
    Hillis-Steele suffix scan, then a Hillis-Steele reduction, over the
    bucket axis, each step one full add over every (row, bucket) lane.
    Returns T as (8, rows) coordinates."""
    n_buckets = X.shape[2]
    idx = torch.arange(n_buckets, device=X.device)
    log_b = (n_buckets - 1).bit_length()

    def step_add(p, step):  # p + roll(p, -step), lanes past the end masked to Z = 0
        q = tuple(torch.roll(c, -step, dims=2) for c in p)
        q = (q[0], q[1], torch.where(idx < n_buckets - step, q[2], 0))
        out = g1_jadd_plain(*(c.reshape(8, -1) for c in (*p, *q)))
        return tuple(c.reshape(X.shape) for c in out)

    s = (X, Y, Z)
    for i in range(log_b):
        s = step_add(s, 1 << i)
    t = (s[0], s[1], torch.where(idx >= 1, s[2], 0))  # drop S_0
    for i in range(log_b):
        t = step_add(t, 1 << i)
    return tuple(c[:, :, 0].contiguous() for c in t)


def comb_rounds(step, table, table_inf, scalars):
    """The SRS comb as 32 calls of `step(X1, Y1, Z1, X2, Y2, q_inf)`, a full
    mixed add (K3's plain version or K3 itself): from acc = (one, one, 0),
    window w = 0 .. 31 adds the table row w * 256 + digit w of each scalar.
    table: (32 * 256, 16) packed affine rows, row w * 256 + d = d * 2^(8w)
    * G; table_inf: (32 * 256,) bool; scalars: (8, N) standard-form limbs.
    Returns the (8, N) Jacobian sums."""
    n = scalars.shape[1]
    one, zero = _one_zero(torch.empty((8, n), dtype=torch.int32, device=scalars.device))
    acc = (one.contiguous(), one.contiguous(), zero)
    u = u64(scalars)
    for w in range(COMB_WINDOWS):
        idx = w * COMB_ENTRIES + ((u[w // 4] >> (8 * (w % 4))) & 0xFF)
        X2, Y2 = unpack_rows(table.index_select(0, idx))
        acc = step(*acc, X2, Y2, table_inf.index_select(0, idx))
    return acc


def fixed_base_comb_plain(table, table_inf, scalars):
    """The SRS comb's function: `_fixed_base_msm_kernel` (JAX srs.py:90-112),
    `comb_rounds` on K3's plain version."""
    return comb_rounds(g1_madd_plain, table, table_inf, scalars)


# -- wrappers ------------------------------------------------------------------


def _check(name, coords, n, device, extra=()):
    for t in coords:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if tuple(t.shape) != (8, n):
            raise ValueError(f"{name}: expected shape (8, {n}), got {tuple(t.shape)}")
    for t, dtype, shape in extra:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in list(coords) + [e[0] for e in extra]:
        if t.device != device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {device}")


def _outputs(like):
    return torch.empty_like(like), torch.empty_like(like), torch.empty_like(like)


def g1_jadd(X1, Y1, Z1, X2, Y2, Z2, nodouble: bool = False):
    """K2: (X1, Y1, Z1) + (X2, Y2, Z2), all (8, N) Jacobian."""
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check("g1_jadd", (X1, Y1, Z1, X2, Y2, Z2), n, X1.device)
    if X1.device.type == "cpu":
        return g1_jadd_plain(X1, Y1, Z1, X2, Y2, Z2, nodouble)
    out = _outputs(X1)
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_jadd(
        X1.data_ptr(), Y1.data_ptr(), Z1.data_ptr(), X2.data_ptr(), Y2.data_ptr(),
        Z2.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), n,
        int(nodouble), kernels.stream_ptr(X1.device),
    )
    kernels.check(rc, "g1_jadd")
    LAUNCHES["g1_jadd"] += 1
    return out


def _madd_launch(X1, Y1, Z1, x2_ptr, y2_ptr, q_inf, nodouble, packed):
    out = _outputs(X1)
    n = X1.shape[1]
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_madd(
        X1.data_ptr(), Y1.data_ptr(), Z1.data_ptr(), x2_ptr, y2_ptr, q_inf.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), n, int(nodouble),
        int(packed), kernels.stream_ptr(X1.device),
    )
    name = "g1_madd_packed" if packed else "g1_madd"
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def g1_madd(X1, Y1, Z1, X2, Y2, q_inf, nodouble: bool = False):
    """K3: Jacobian (X1, Y1, Z1) + affine (X2, Y2); q_inf marks affine
    operands at infinity."""
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check("g1_madd", (X1, Y1, Z1, X2, Y2), n, X1.device, [(q_inf, torch.bool, (n,))])
    if X1.device.type == "cpu":
        return g1_madd_plain(X1, Y1, Z1, X2, Y2, q_inf, nodouble)
    return _madd_launch(X1, Y1, Z1, X2.data_ptr(), Y2.data_ptr(), q_inf, nodouble, False)


def g1_madd_packed(X1, Y1, Z1, packed, q_inf, nodouble: bool = False):
    """K4: K3 with the affine operand as (N, 16) int32 rows."""
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check(
        "g1_madd_packed", (X1, Y1, Z1), n, X1.device,
        [(packed, torch.int32, (n, PACK_WORDS)), (q_inf, torch.bool, (n,))],
    )
    if X1.device.type == "cpu":
        return g1_madd_packed_plain(X1, Y1, Z1, packed, q_inf, nodouble)
    return _madd_launch(X1, Y1, Z1, packed.data_ptr(), packed.data_ptr(), q_inf, nodouble, True)


def window_sums(X, Y, Z):
    """The MSM's window sums in one launch: (8, rows, B) int32 canonical
    Jacobian buckets -> T as (8, rows) coordinates (`window_sums_plain`)."""
    coords = (X, Y, Z)
    shape = tuple(X.shape)
    for t in coords:
        if t.dtype != torch.int32:
            raise TypeError(f"window_sums: expected int32 limbs, got {t.dtype}")
        if t.dim() != 3 or t.shape[0] != 8 or tuple(t.shape) != shape:
            raise ValueError(f"window_sums: expected three (8, rows, B) tensors, got {tuple(t.shape)}")
    _check("window_sums", (), 0, X.device, [(t, torch.int32, shape) for t in coords])
    if X.device.type == "cpu":
        return window_sums_plain(X, Y, Z)
    rows, n_buckets = shape[1], shape[2]
    if not 1 <= n_buckets <= WINDOW_MAX_BUCKETS:
        raise ValueError(f"window_sums: {n_buckets} buckets, the kernel takes 1 to {WINDOW_MAX_BUCKETS}")
    out = tuple(torch.empty((8, rows), dtype=torch.int32, device=X.device) for _ in range(3))
    if rows == 0:
        return out
    rc = kernels.lib().pht_g1_window_sums(
        X.data_ptr(), Y.data_ptr(), Z.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), rows, n_buckets, kernels.stream_ptr(X.device),
    )
    kernels.check(rc, "window_sums")
    LAUNCHES["window_sums"] += 1
    return out


def fixed_base_comb(table, table_inf, scalars):
    """The SRS comb in one launch (`fixed_base_comb_plain`): table (32 * 256,
    16) int32 rows, 16-byte aligned on the card; table_inf (32 * 256,) bool;
    scalars (8, N) int32 standard-form limbs. Returns (8, N) Jacobian."""
    n = scalars.shape[1] if scalars.dim() == 2 else -1
    rows = COMB_WINDOWS * COMB_ENTRIES
    _check("fixed_base_comb", (scalars,), n, scalars.device,
           [(table, torch.int32, (rows, PACK_WORDS)), (table_inf, torch.bool, (rows,))])
    if scalars.device.type == "cpu":
        return fixed_base_comb_plain(table, table_inf, scalars)
    if table.data_ptr() % 16:
        raise ValueError("fixed_base_comb: table rows must be 16-byte aligned")
    out = _outputs(scalars)
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_fixed_base_comb(
        table.data_ptr(), table_inf.data_ptr(), scalars.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), n, kernels.stream_ptr(scalars.device),
    )
    kernels.check(rc, "fixed_base_comb")
    LAUNCHES["fixed_base_comb"] += 1
    return out
