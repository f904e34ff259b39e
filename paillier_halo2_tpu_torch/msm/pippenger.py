"""Pippenger multi-scalar multiplication with unsigned windows.

Counterpart of `paillier_halo2_tpu/msm/pippenger.py:1`, canonical (non-lazy)
path — the one the JAX package takes with `PAILLIER_TPU_LAZY=0` and on CPU
(`pippenger.py:324-330`, `:370-375`):

- window keys slice straight out of the scalar limbs (window bits divide 8);
- bucket accumulation sorts each window's keys and runs gather-rounds: round
  r gathers, for every (window, bucket, sub-accumulator) lane, the next point
  of that bucket's sorted run as a packed row and adds it with K4 under
  `nodouble` (bases are distinct);
- the sub-accumulators merge in a log-depth roll-and-add tree (K2, nodouble);
- window sums T_w = sum_b b * B_{w,b} by a Hillis-Steele suffix scan and
  reduction over the bucket axis (K2, full);
- the Horner combine of the window sums runs on the host.

The round count is data-dependent (a `lax.while_loop` in the JAX package);
here it costs one host readback per MSM. Lanes are ordered by the number of
rounds they need, so round r runs K4 on a prefix of the lanes — lanes whose
runs have ended do no work. Commitments are points, so the schedule changes
no result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ec import bn254
from ..ec import host as ech
from ..ff import field as f
from ..ff.limbs16 import u64

N_LIMBS = 8


def _keys_from_digits(scalar_limbs: torch.Tensor, window_bits: int) -> torch.Tensor:
    """(..., 8, N) standard-form scalar limbs -> (..., n_windows, N) int64
    c-bit window keys, least significant window first."""
    assert 8 % window_bits == 0
    mask = (1 << window_bits) - 1
    u = u64(scalar_limbs)
    parts = [(u >> (window_bits * j)) & mask for j in range(32 // window_bits)]
    stacked = torch.stack(parts, dim=-2)  # (..., 8, per_limb, N)
    return stacked.reshape(scalar_limbs.shape[:-2] + (-1, scalar_limbs.shape[-1]))


def _inf_points(n: int, device) -> bn254.JPoint:
    one = bn254.SPEC.limbs("one_mont", device)[:, None].expand(N_LIMBS, n).contiguous()
    return (one, one.clone(), torch.zeros((N_LIMBS, n), dtype=torch.int32, device=device))


def default_schedule(device) -> tuple[int, int]:
    """(s_base, s_cap) sub-accumulator budget (`pippenger.py:76-96`): on the
    card extra lanes are nearly free and cutting the round count pays. On the
    CPU a round's fixed cost is a few hundred plain-torch ops, so a moderate
    budget pays too: (4, 32) took 11.5 s where (1, 8) took 15.0 s for 33
    commitments of 2^10 points at window 4 on an 8-core x86 CPU."""
    return (4, 32) if torch.device(device).type == "cpu" else (8, 64)


def _sub_schedule(n_windows: int, window_bits: int, s_base: int, s_cap: int) -> tuple[int, ...]:
    """Static per-window sub-accumulator counts. Scalars are < r, so the top
    window's keys take only V = (r >> shift) + 1 values; overloaded windows
    get proportionally more sub-accumulators (`pippenger.py:99-121`)."""
    out = []
    for w in range(n_windows):
        v = min(1 << window_bits, (ech.R >> (window_bits * w)) + 1)
        overload = (1 << window_bits) / v
        s = s_base
        while s < s_base * overload and s < s_cap:
            s *= 2
        out.append(s)
    return tuple(out)


def _bucket_accumulate(px, py, p_inf, keys, window_bits: int, subs: tuple[int, ...]):
    """Per-(window, bucket) sums. px/py: (8, N) affine Montgomery bases; p_inf:
    (N,) bool; keys: (W, N) window keys. Returns Jacobian buckets, each
    coordinate (8, W, 2^window_bits). Bases must be pairwise distinct."""
    device = px.device
    n = px.shape[1]
    n_windows = keys.shape[0]
    n_buckets = 1 << window_bits
    assert len(subs) == n_windows
    packed = bn254.pack_points_dense(px, py)  # (N, 16)
    keys = torch.where(p_inf[None, :], 0, keys.to(torch.int64))
    logn = max((n - 1).bit_length(), 1)
    lane = torch.arange(n, dtype=torch.int64, device=device)
    sk = torch.sort((keys << logn) | lane[None, :], dim=1).values  # stable by lane
    sorted_keys = (sk >> logn).contiguous()
    order_flat = (sk & ((1 << logn) - 1)).reshape(-1)

    targets = torch.arange(n_buckets, dtype=torch.int64, device=device).expand(n_windows, -1)
    seg_start = torch.searchsorted(sorted_keys, targets.contiguous())
    counts = torch.searchsorted(sorted_keys, targets.contiguous(), right=True) - seg_start
    counts[:, 0] = 0  # bucket 0 contributes nothing

    # Static lane maps: windows grouped by sub-count into rectangular blocks
    # (rows, buckets, subs), flattened C-order onto one lane axis.
    blocks: list[tuple[int, list[int]]] = []
    for w in sorted(range(n_windows), key=lambda w: subs[w]):
        if blocks and blocks[-1][0] == subs[w]:
            blocks[-1][1].append(w)
        else:
            blocks.append((subs[w], [w]))
    win_np, bkt_np, sub_np, nsub_np = [], [], [], []
    for s, rows in blocks:
        nr = len(rows)
        win_np.append(np.repeat(np.array(rows, np.int64), n_buckets * s))
        bkt_np.append(np.tile(np.repeat(np.arange(n_buckets, dtype=np.int64), s), nr))
        sub_np.append(np.tile(np.arange(s, dtype=np.int64), nr * n_buckets))
        nsub_np.append(np.full(nr * n_buckets * s, s, np.int64))
    as_t = lambda parts: torch.from_numpy(np.concatenate(parts)).to(device)  # noqa: E731
    win_map, bkt_map, sub_map, nsub_map = (as_t(x) for x in (win_np, bkt_np, sub_np, nsub_np))
    n_lanes = win_map.shape[0]
    seg_l = seg_start.reshape(-1)[win_map * n_buckets + bkt_map]
    counts_l = counts.reshape(-1)[win_map * n_buckets + bkt_map]

    # rounds each lane needs; order lanes by it so round r is a lane prefix
    need = torch.clamp(counts_l - sub_map + nsub_map - 1, min=0) // nsub_map
    perm = torch.argsort(need, descending=True, stable=True)
    hist = torch.bincount(need).cpu().tolist()  # the one readback per MSM
    active = [sum(hist[r + 1 :]) for r in range(len(hist) - 1)]
    seg_p, counts_p, sub_p, nsub_p, win_p = (
        x[perm] for x in (seg_l, counts_l, sub_map, nsub_map, win_map)
    )

    acc = _inf_points(n_lanes, device)
    for r, m in enumerate(active):
        j = sub_p[:m] + r * nsub_p[:m]  # index within the bucket's sorted run
        pos = torch.clamp(seg_p[:m] + j, 0, n - 1)
        idx = order_flat[win_p[:m] * n + pos]  # original point indices
        rows = packed.index_select(0, idx)  # (m, 16)
        mask_off = j >= counts_p[:m]
        out = bn254.padd_mixed_packed(tuple(c[:, :m] for c in acc), rows, mask_off, nodouble=True)
        for c, o in zip(acc, out):
            c[:, :m] = o
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n_lanes, dtype=perm.dtype, device=device)
    acc = tuple(c.index_select(1, inv) for c in acc)

    # Merge each block's S sub-accumulators with a log-depth roll-and-add
    # fold (step i only needs lanes < S >> i right), then restore the
    # window-row order.
    parts = []
    row_order: list[int] = []
    off = 0
    for s, rows in blocks:
        nr = len(rows)
        lb = nr * n_buckets * s
        blk = tuple(c[:, off : off + lb].reshape(N_LIMBS, nr, n_buckets, s) for c in acc)
        for i in range(s.bit_length() - 1):
            half = s >> (i + 1)
            shifted = tuple(torch.roll(c, -half, dims=3) for c in blk)
            blk = bn254.padd(blk, shifted, nodouble=True)
        parts.append(tuple(c[..., 0] for c in blk))  # (8, nr, n_buckets)
        row_order.extend(rows)
        off += lb
    merged = tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))
    inv_rows = torch.from_numpy(np.argsort(np.array(row_order))).to(device)
    return tuple(c.index_select(1, inv_rows) for c in merged)


def _window_sums(buckets, n_buckets: int):
    """T_w = sum_b b * B_{w,b} via the suffix-sum identity: a Hillis-Steele
    suffix scan, then a Hillis-Steele reduction over the bucket axis
    (`pippenger.py:401-432`). buckets: coordinates (8, W, B)."""
    device = buckets[0].device
    idx = torch.arange(n_buckets, device=device)
    log_b = (n_buckets - 1).bit_length()

    def masked(p, valid):  # invalid lanes become infinity (Z = 0)
        return (p[0], p[1], torch.where(valid, p[2], 0))

    s = buckets
    for i in range(log_b):
        step = 1 << i
        shifted = tuple(torch.roll(c, -step, dims=2) for c in s)
        s = bn254.padd(s, masked(shifted, idx < n_buckets - step))
    t = masked(s, idx >= 1)  # drop S_0 (bucket weights start at 1)
    for i in range(log_b):
        step = 1 << i
        shifted = tuple(torch.roll(c, -step, dims=2) for c in t)
        t = bn254.padd(t, masked(shifted, idx < n_buckets - step))
    return tuple(c[:, :, 0] for c in t)


def msm_packed_multi(px, py, p_inf, scalars, window_bits: int = 8,
                     s_base: int | None = None, s_cap: int | None = None) -> list[ech.Point]:
    """Batched MSMs sharing one base set. scalars: (P, 8, N) standard-form
    limbs; returns P host affine results. The poly axis folds into the
    window axis, so P commitments share one bucket loop."""
    assert scalars.dim() == 3
    n_polys = scalars.shape[0]
    if s_base is None or s_cap is None:
        d_base, d_cap = default_schedule(px.device)
        s_base = d_base if s_base is None else s_base
        s_cap = d_cap if s_cap is None else s_cap
    keys = _keys_from_digits(scalars, window_bits)  # (P, W, N)
    n_windows = keys.shape[1]
    keys = keys.reshape(n_polys * n_windows, -1)
    subs = _sub_schedule(n_windows, window_bits, s_base, s_cap) * n_polys  # row = p*W + w
    buckets = _bucket_accumulate(px, py, p_inf, keys, window_bits, subs)
    tw = _window_sums(buckets, 1 << window_bits)
    pts = bn254.unpack_jacobian(tw)  # (P*W) window sums, poly-major
    out = []
    for pi in range(n_polys):
        acc = None
        for p in reversed(pts[pi * n_windows : (pi + 1) * n_windows]):
            for _ in range(window_bits):
                acc = ech.g1_double(acc)
            acc = ech.g1_add(acc, p)
        out.append(acc)
    return out


def msm_packed(px, py, p_inf, scalar_limbs, window_bits: int = 8) -> ech.Point:
    """MSM over packed affine bases and (8, N) standard-form scalar limbs;
    the result is a host affine point."""
    return msm_packed_multi(px, py, p_inf, scalar_limbs[None], window_bits)[0]


def msm(points: list[ech.Point], scalars: list[int], device, window_bits: int = 8) -> ech.Point:
    """Convenience entry: host points + host int scalars."""
    assert len(points) == len(scalars)
    px, py, p_inf = bn254.pack_affine(points, device)
    sd = f.pack_ints([s % ech.R for s in scalars], device)
    return msm_packed(px, py, p_inf, sd, window_bits)
