"""K5, K6: the signed-window MSM's G1 additions on redundant-form
accumulators — the wrappers around `csrc/g1_add_lazy.cu` and their plain
PyTorch versions.

Counterpart of `paillier_halo2_tpu/ec/lazy_point.py:1`:

- `padd_mixed_packed_lazy` (K5) <- `padd_mixed_packed_lazy` (:172): one bucket
  step, accumulator + (+-P) with P from packed `(N, 16)` rows; `neg` lanes
  use p - y, `mask_off` lanes pass the accumulator through;
- `bucket_loop_lazy` <- K5 under the `lax.while_loop` of
  `paillier_halo2_tpu/msm/pippenger.py:305-330`: the signed MSM's whole
  bucket loop in one launch, each lane's additions in the rounds' order;
- `padd_lazy` (K6) <- `padd_lazy` (:220): Jacobian + Jacobian, either side
  possibly at infinity, the q_inf select outermost (:124-126);
- `merge_lazy` <- K6 under the `lax.fori_loop` of
  `paillier_halo2_tpu/msm/pippenger.py:335-375`: the signed MSM's whole
  sub-accumulator merge, its canonicalisation, the capped windows' padding
  and the window-row order, in one launch;
- `inf_acc`, `to_lazy_jp`, `canonicalize_jp` <- :243-270, the pipeline's
  entry and exit.

Accumulator coordinates are `(8, N)` int32 Fq limbs in Montgomery form with
values in [0, 2p) (`ff/lazy_mont.py`); infinity is Z == 0 exactly, which
every redundant-form operation preserves. Both kernels are nodouble only: a
lane with P == +-Q degrades to a Z that is zero mod p, which
`canonicalize_jp` maps to exact zero, never to a wrong finite point. On a
CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version, which takes the same products, sums, differences and
selects in the same order, so the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ff import lazy_mont as lz
from ..ff.field import is_zero as _is_zero
from ..ff.limbs16 import M32, to_i32, u64
from ..utils import kernels
from .point_kernels import PACK_WORDS, SPEC, _check, _outputs, _sel, unpack_rows

LAUNCHES = {"padd_mixed_packed_lazy": 0, "padd_lazy": 0, "bucket_loop_lazy": 0,
            "merge_lazy": 0}
MERGE_THREADS = 128  # the merge kernel's CTA
MERGE_WARP_MAX_S = 256  # up to here s/8 threads of one warp own a bucket
MERGE_BLOCK_LEAVES = 512  # above it, a CTA per 512 sub-accumulators of a bucket


def _mul(a, b):
    return lz.mont_mul_lazy_plain(SPEC, a, b)


def _add(a, b):
    return lz.add_lazy(SPEC, a, b)


def _sub(a, b):
    return lz.sub_lazy(SPEC, a, b)


def _neg_y(y, neg):
    """p - y on `neg` lanes (y canonical, so p - y is in (0, p])."""
    uy = u64(y)
    out, bw = [], 0
    for k in range(8):
        x = SPEC.p_limbs[k] - uy[k] - bw
        out.append(x & M32)
        bw = (x >> 32) & 1
    return torch.where(neg, to_i32(torch.stack(out)), y)


def padd_mixed_packed_lazy_plain(X1, Y1, Z1, packed, mask_off, neg):
    """K5's function: `_mixed_add_lazy` (lazy_point.py:51-92) with the
    operand from packed rows, negated where `neg` is set (:157-159)."""
    X2, Y2 = unpack_rows(packed)
    Y2 = _neg_y(Y2, neg)
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
    p_inf = _is_zero(Z1)
    one = SPEC.limbs("one_mont", X1.device)[:, None].expand_as(X1)
    zero = torch.zeros_like(X1)
    X3, Y3 = _sel(p_inf, X2, X3), _sel(p_inf, Y2, Y3)
    Z3 = _sel(p_inf, _sel(mask_off, zero, one), Z3)
    X3, Y3, Z3 = _sel(mask_off, X1, X3), _sel(mask_off, Y1, Y3), _sel(mask_off, Z1, Z3)
    return X3, Y3, Z3


def padd_lazy_plain(X1, Y1, Z1, X2, Y2, Z2):
    """K6's function: `_jacobian_add_lazy` (lazy_point.py:95-129)."""
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
    p_inf = _is_zero(Z1)
    q_inf = _is_zero(Z2)
    X3 = _sel(q_inf, X1, _sel(p_inf, X2, X3))
    Y3 = _sel(q_inf, Y1, _sel(p_inf, Y2, Y3))
    Z3 = _sel(q_inf, Z1, _sel(p_inf, Z2, Z3))
    return X3, Y3, Z3


def _need(count, sub, nsub):
    """Additions a lane makes: j = sub, sub + nsub, ... < count."""
    return torch.clamp(count - sub + nsub - 1, min=0) // nsub


def bucket_rounds(step, packed, order, neg, seg, count, sub, nsub, win, lane, n: int):
    """The bucket loop as gather-rounds, each round one call of `step`, a
    mixed add `step(X, Y, Z, rows, mask_off, neg)` (K5's plain version, K5
    itself, or K4 with neg=None): round r adds, on every lane that still has
    a point, point order[win*n + seg + j] with j = sub + r*nsub, negated
    where neg at that sorted position is set; accumulators start at infinity
    (one, one, 0). The lanes must come sorted by need, descending, so round r
    runs on a prefix of them. Returns (8, n_lanes) accumulators, lane i's in
    column lane[i]."""
    need = _need(count.long(), sub.long(), nsub.long())
    if need.numel() > 1 and bool((need[1:] > need[:-1]).any()):
        raise ValueError("bucket_rounds: lanes must be sorted by need, descending")
    hist = torch.bincount(need).cpu().tolist()  # the one readback per call
    active = [sum(hist[r + 1 :]) for r in range(len(hist) - 1)]
    seg, count, sub, nsub, win, order = (x.long() for x in (seg, count, sub, nsub, win, order))
    acc = inf_acc(seg.shape[0], packed.device)
    for r, m in enumerate(active):
        j = sub[:m] + r * nsub[:m]  # index within the bucket's sorted run
        at = win[:m] * n + torch.clamp(seg[:m] + j, 0, n - 1)
        rows = packed.index_select(0, order[at])  # (m, 16)
        mask_off = j >= count[:m]
        lanes = tuple(c[:, :m].contiguous() for c in acc)
        out = step(*lanes, rows, mask_off, None if neg is None else neg[at])
        for c, o in zip(acc, out):
            c[:, :m] = o
    placed = tuple(torch.empty_like(c) for c in acc)
    for p, c in zip(placed, acc):
        p[:, lane.long()] = c
    return placed


def bucket_loop_lazy_plain(packed, order, neg, seg, count, sub, nsub, win, lane, n: int):
    """The bucket loop's function: `bucket_rounds` on K5's plain version."""
    return bucket_rounds(padd_mixed_packed_lazy_plain, packed, order, neg, seg, count, sub, nsub,
                         win, lane, n)


def merge_rounds(step, acc, blocks, n_buckets: int):
    """The merge as halving levels, each level one call of `step(lo, hi)`, a
    Jacobian add of two triples of (8, L) coordinates (K6's plain version,
    K6 itself, or K2 nodouble on the unsigned route). acc: three (8,
    n_lanes) accumulators, the bucket loop's output; blocks: the lane
    layout, a list of (s, bcap, rows), block by block (s, rows, bcap)
    C-order, s a power of two. Each bucket's s sub-accumulators reduce by
    out[j] = t[j] + t[j + half], t[j] first; capped windows' dead buckets
    are (0, 0, 0). Returns three (8, W, n_buckets) tensors in window-row
    order, W the number of rows."""
    parts, row_order, off = [], [], 0
    for s, bc, rows in blocks:
        nr = len(rows)
        lb = nr * bc * s
        blk = tuple(c[:, off : off + lb].reshape(8, s, nr * bc) for c in acc)
        half = s
        while half > 1:
            half //= 2
            lo = tuple(c[:, :half].reshape(8, -1).contiguous() for c in blk)
            hi = tuple(c[:, half:].reshape(8, -1).contiguous() for c in blk)
            blk = tuple(c.reshape(8, half, nr * bc) for c in step(lo, hi))
        first = torch.stack([c[:, 0] for c in blk]).reshape(3, 8, nr, bc)
        if bc < n_buckets:
            first = torch.nn.functional.pad(first, (0, n_buckets - bc))
        parts.append(first)
        row_order.extend(rows)
        off += lb
    merged = torch.cat(parts, dim=2)
    inv_rows = torch.from_numpy(np.argsort(np.array(row_order))).to(merged.device)
    return tuple(merged[i].index_select(1, inv_rows) for i in range(3))


def merge_lazy_plain(acc, blocks, n_buckets: int):
    """The merge's function: `merge_rounds` on K6's plain version, then
    `canonicalize_jp`: canonical Jacobian buckets (8, W, n_buckets)."""
    return canonicalize_jp(*merge_rounds(lambda lo, hi: padd_lazy_plain(*lo, *hi), acc, blocks,
                                         n_buckets))


def merge_meta(blocks, n_buckets: int):
    """The merge kernel's block table (`g1_merge_lazy_kernel`): one int32
    entry a block (lane offset, s, bcap, rows, first row, first CTA, first
    counter slot, G, P), then the window row of every block row. A bucket's
    s sub-accumulators go to G threads of s/G leaves each: G = s/8 threads
    of one warp (P = 0) up to s = 256, else P = s/512 CTAs of 128 threads
    with 4 leaves each. Returns (meta, n_ctas, n_slots, n_lanes, n_rows,
    smem_slots, max_parts); raises ValueError on a layout the kernel does
    not take."""
    entries, row_list, lane_off, cta, slots, depth, parts = [], [], 0, 0, 0, 1, 0
    for s, bc, rows in blocks:
        nr = len(rows)
        if s < 1 or s & (s - 1) or not 1 <= bc <= n_buckets or nr < 1:
            raise ValueError(f"merge_lazy: block (s={s}, bcap={bc}, {nr} rows) not taken")
        if s <= MERGE_WARP_MAX_S:
            group, n_parts, slot = max(s // 8, 1), 0, 0
            ctas = -(-nr * n_buckets // (MERGE_THREADS // group))
        else:
            n_parts = s // MERGE_BLOCK_LEAVES
            group, slot = MERGE_THREADS * n_parts, slots
            ctas = nr * bc * n_parts + nr * (n_buckets - bc)
            slots += nr * bc
        entries.append([lane_off, s, bc, nr, len(row_list), cta, slot, group, n_parts])
        row_list.extend(rows)
        lane_off += nr * bc * s
        cta += ctas
        depth = max(depth, (s // group).bit_length() - 1)
        parts = max(parts, n_parts)
    if sorted(row_list) != list(range(len(row_list))):
        raise ValueError("merge_lazy: the blocks' rows must be 0 .. W-1, each once")
    if max(lane_off, cta, slots * max(parts, 1)) >= 1 << 31:
        raise ValueError("merge_lazy: more lanes than int32 offsets hold")
    meta = np.array([v for e in entries for v in e] + row_list, dtype=np.int32)
    return meta, cta, slots, lane_off, len(row_list), depth, parts


# -- wrappers ------------------------------------------------------------------


def padd_mixed_packed_lazy(X1, Y1, Z1, packed, mask_off, neg):
    """K5: accumulators (8, N) + the (N, 16) int32 packed rows, `mask_off`
    and `neg` (N,) bool masks."""
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check(
        "padd_mixed_packed_lazy", (X1, Y1, Z1), n, X1.device,
        [(packed, torch.int32, (n, PACK_WORDS)), (mask_off, torch.bool, (n,)),
         (neg, torch.bool, (n,))],
    )
    if X1.device.type == "cpu":
        return padd_mixed_packed_lazy_plain(X1, Y1, Z1, packed, mask_off, neg)
    out = _outputs(X1)
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_madd_lazy(
        X1.data_ptr(), Y1.data_ptr(), Z1.data_ptr(), packed.data_ptr(), mask_off.data_ptr(),
        neg.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), n,
        kernels.stream_ptr(X1.device),
    )
    kernels.check(rc, "padd_mixed_packed_lazy")
    LAUNCHES["padd_mixed_packed_lazy"] += 1
    return out


def bucket_loop_lazy(packed, order, neg, seg, count, sub, nsub, win, lane, n: int):
    """The signed MSM's bucket loop in one launch (`bucket_loop_lazy_plain`).
    packed: (n, 16) int32 rows; order: (W*n,) int32 point indices and neg:
    (W*n,) bool, both by sorted position; seg, count, sub, nsub, win, lane:
    (n_lanes,) int32 lane table, best sorted by need descending so a warp's
    lanes finish together."""
    n_lanes = seg.shape[0] if seg.dim() == 1 else -1
    m = order.shape[0] if order.dim() == 1 else -1
    table = [(t, torch.int32, (n_lanes,)) for t in (seg, count, sub, nsub, win, lane)]
    _check("bucket_loop_lazy", (), 0, packed.device,
           [(packed, torch.int32, (n, PACK_WORDS)), (order, torch.int32, (m,)),
            (neg, torch.bool, (m,))] + table)
    if packed.device.type == "cpu":
        return bucket_loop_lazy_plain(packed, order, neg, seg, count, sub, nsub, win, lane, n)
    if packed.data_ptr() % 16:
        raise ValueError("bucket_loop_lazy: packed rows must be 16-byte aligned")
    out = tuple(torch.empty((8, n_lanes), dtype=torch.int32, device=packed.device)
                for _ in range(3))
    if n_lanes == 0:
        return out
    rc = kernels.lib().pht_g1_bucket_lazy(
        *(t.data_ptr() for t in (packed, order, neg, seg, count, sub, nsub, win, lane)),
        *(c.data_ptr() for c in out), n_lanes, n, kernels.stream_ptr(packed.device),
    )
    kernels.check(rc, "bucket_loop_lazy")
    LAUNCHES["bucket_loop_lazy"] += 1
    return out


def padd_lazy(P1, P2):
    """K6: P1 + P2, each a triple of (8, N) redundant-form coordinates."""
    coords = tuple(P1) + tuple(P2)
    X1 = coords[0]
    n = X1.shape[1] if X1.dim() == 2 else -1
    _check("padd_lazy", coords, n, X1.device)
    if X1.device.type == "cpu":
        return padd_lazy_plain(*coords)
    out = _outputs(X1)
    if n == 0:
        return out
    rc = kernels.lib().pht_g1_jadd_lazy(
        *(c.data_ptr() for c in coords), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), n, kernels.stream_ptr(X1.device),
    )
    kernels.check(rc, "padd_lazy")
    LAUNCHES["padd_lazy"] += 1
    return out


def merge_lazy(acc, blocks, n_buckets: int):
    """The signed MSM's merge in one launch (`merge_lazy_plain`): acc three
    (8, n_lanes) int32 accumulators in [0, 2p), the bucket loop's output in
    the lane layout `blocks` gives; returns canonical Jacobian buckets, three
    (8, W, n_buckets) int32 tensors in window-row order."""
    meta, n_ctas, n_slots, n_lanes, n_rows, smem_slots, parts = merge_meta(blocks, n_buckets)
    X = acc[0]
    _check("merge_lazy", tuple(acc), n_lanes, X.device)
    if X.device.type == "cpu":
        return merge_lazy_plain(acc, blocks, n_buckets)
    dev = X.device
    out = tuple(torch.empty((8, n_rows, n_buckets), dtype=torch.int32, device=dev)
                for _ in range(3))
    n_scratch = n_slots * parts if parts > 1 else 0  # T(c, P) of the CTAs of a bucket
    scratch = [torch.empty((8, n_scratch), dtype=torch.int32, device=dev) for _ in range(3)]
    counters = torch.zeros(n_slots if n_scratch else 0, dtype=torch.int32, device=dev)
    meta_t = torch.from_numpy(meta).to(dev)
    ptr = lambda t: t.data_ptr() if t.numel() else None  # noqa: E731
    rc = kernels.lib().pht_g1_merge_lazy(
        *(c.data_ptr() for c in acc), meta_t.data_ptr(), len(blocks),
        *(c.data_ptr() for c in out), *(ptr(c) for c in scratch), ptr(counters),
        n_lanes, n_scratch, n_rows * n_buckets, n_buckets, n_ctas, smem_slots,
        kernels.stream_ptr(dev),
    )
    kernels.check(rc, "merge_lazy")
    LAUNCHES["merge_lazy"] += 1
    return out


# -- the pipeline's entry and exit ------------------------------------------------


def inf_acc(n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n fresh accumulators at infinity: (one, one, 0), as `inf_acc` (:243)."""
    one = SPEC.limbs("one_mont", device)[:, None].expand(8, n).contiguous()
    return one, one.clone(), torch.zeros((8, n), dtype=torch.int32, device=device)


def to_lazy_jp(p):
    """Canonical Jacobian coordinates -> accumulators (:253). Canonical
    values already lie in [0, 2p), so this only makes them contiguous."""
    return tuple(c.contiguous() for c in p)


def canonicalize_jp(X, Y, Z):
    """Accumulators -> canonical Jacobian coordinates in [0, p) (:259). A Z
    that is zero mod p (p itself, from a broken nodouble contract) becomes
    exact zero, the infinity encoding."""
    return tuple(lz.canonicalize(SPEC, c) for c in (X, Y, Z))
