"""Pippenger multi-scalar multiplication, on two routes that give the same
points.

Counterpart of `paillier_halo2_tpu/msm/pippenger.py:1`:

- the signed route, the one the JAX package takes on its accelerator
  (`_use_lazy()`, `pippenger.py:67-73`): c-bit signed windows
  (`_signed_keys`, c from `_signed_window_bits`), 2^(c-1)+1 buckets per
  window, per-window sub-accumulator counts and bucket caps
  (`_sub_schedule_signed`); the bucket loop adds +-P by K5's formula on
  redundant-form accumulators, the whole loop in one launch
  (`ec/lazy_point.bucket_loop_lazy`), and the sub-accumulators' merge with
  its canonicalisation is one launch too (`ec/lazy_point.merge_lazy`, K6's
  tree) (`:309-323`, `:347-369`, `:394-397`);
- the unsigned route (`PAILLIER_TPU_LAZY=0` there, and its CPU route):
  window bits that divide 8, keys sliced straight out of the scalar limbs,
  K4 under `nodouble` in the bucket loop, the whole loop in one launch
  (`ec/point_kernels.bucket_loop`), and K2 `nodouble` in the merge.

Both then weight the buckets into window sums T_w = sum_b b * B_{w,b} with a
Hillis-Steele suffix scan and reduction (one launch of the window-sum kernel
over K2's full add), and combine the windows by Horner on the host. The
route follows the device, as `_use_lazy()` does: signed on a CUDA tensor,
unsigned on a CPU tensor; `signed=` asks for either on either.

Bucket accumulation sorts each window's keys; each (window, bucket,
sub-accumulator) lane then adds every nsub-th point of its bucket's sorted
run, read as a packed row (bases are distinct, hence `nodouble`). Both
routes do that in one kernel launch, each lane looping over its own run,
where the JAX package's `lax.while_loop` gathers every lane's next point and
adds it round by round (`point_kernels.bucket_rounds`, the plain versions'
form). Lanes are ordered by the number of additions they need, so a loop
kernel's warp finishes together.
The sub-accumulators merge in a halving tree. Commitments are points, so the schedule changes no result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ec import bn254
from ..ec import host as ech
from ..ec import lazy_point as lzp
from ..ec import point_kernels as pk
from ..ff import field as f
from ..ff.limbs16 import u64

N_LIMBS = 8
MAX_LANES = 1 << 21  # bucket lanes per call on the signed route (`pippenger.py:485-488`)


def _keys_from_digits(scalar_limbs: torch.Tensor, window_bits: int) -> torch.Tensor:
    """(..., 8, N) standard-form scalar limbs -> (..., n_windows, N) int64
    c-bit window keys, least significant window first."""
    assert 8 % window_bits == 0
    mask = (1 << window_bits) - 1
    u = u64(scalar_limbs)
    parts = [(u >> (window_bits * j)) & mask for j in range(32 // window_bits)]
    stacked = torch.stack(parts, dim=-2)  # (..., 8, per_limb, N)
    return stacked.reshape(scalar_limbs.shape[:-2] + (-1, scalar_limbs.shape[-1]))


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


def _signed_window_bits(n: int) -> int:
    """Signed window size for n points (`pippenger.py:435-452`): 8 below
    2^16 points, 9 below 2^19, 11 from 2^19 up."""
    if n >= 1 << 19:
        return 11
    if n >= 1 << 16:
        return 9
    return 8


def _signed_keys(scalar_limbs: torch.Tensor, c: int):
    """Signed window recoding (`pippenger.py:124-155`): (..., 8, N)
    standard-form scalar limbs -> bucket keys (..., W, N) int64 in
    [0, 2^(c-1)] and negation masks (..., W, N) bool, W = ceil(256 / c),
    with scalar = sum_w (-1)^neg_w * key_w * 2^(c*w). No carry escapes the
    top window for scalars below 2^254."""
    n_windows = -(-256 // c)
    u = u64(scalar_limbs)
    mask = (1 << c) - 1
    raw = []
    for w in range(n_windows):
        i, sh = divmod(c * w, 32)
        k = u[..., i, :] >> sh
        spill = c - (32 - sh)  # bits that come from the next limb
        if spill > 0 and i + 1 < N_LIMBS:
            k = k | ((u[..., i + 1, :] & ((1 << spill) - 1)) << (32 - sh))
        raw.append(k & mask)
    half = 1 << (c - 1)
    carry = torch.zeros_like(raw[0])
    keys, negs = [], []
    for w in range(n_windows):
        k = raw[w] + carry  # <= 2^c
        over = k > half
        digit = torch.where(over, k - (1 << c), k)
        carry = over.to(torch.int64)
        negs.append(digit < 0)
        keys.append(digit.abs())
    return torch.stack(keys, dim=-2), torch.stack(negs, dim=-2)


def _sub_schedule_signed(n_windows: int, c: int, s_base: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Per-window (sub-accumulator counts, bucket caps) for signed windows
    (`pippenger.py:163-186`). The top windows' keys take only
    V = (r >> c*w) + carry values, so their bucket lanes are capped at V
    and their sub-accumulator counts grow by about 2^(c-1) / V instead."""
    n_buckets = (1 << (c - 1)) + 1
    subs, bcaps = [], []
    for w in range(n_windows):
        v = min(n_buckets, (ech.R >> (c * w)) + 3)
        overload = n_buckets / v
        s = s_base
        while s < s_base * overload and s < 4096:
            s *= 2
        subs.append(s)
        bcaps.append(v)
    return tuple(subs), tuple(bcaps)


def _lanes_per_poly(subs, bcaps) -> int:
    return sum(s * b for s, b in zip(subs, bcaps))


def _bucket_accumulate(px, py, p_inf, keys, n_buckets: int, subs: tuple[int, ...],
                       bcaps: tuple[int, ...] | None = None, neg=None, stats=None):
    """Per-(window, bucket) sums. px/py: (8, N) affine Montgomery bases; p_inf:
    (N,) bool; keys: (W, N) keys in [0, n_buckets); neg: (W, N) bool
    negation masks, which select the signed route (the lazy bucket-loop
    and merge kernels; else K4's bucket loop and K2's merge). bcaps[w] caps
    window w's bucket lanes (its keys stay below it); the buckets above a
    cap are infinity. Returns canonical Jacobian buckets, each coordinate
    (8, W, n_buckets). Bases must be pairwise distinct. Three steps, each
    its own function so that `benches/profile_chip.py` can time it:
    `_bucket_plan`, `_bucket_loop`, `_bucket_merge`."""
    loop_args, blocks = _bucket_plan(px, py, p_inf, keys, n_buckets, subs, bcaps, neg, stats)
    return _bucket_merge(_bucket_loop(loop_args, neg is not None), blocks, n_buckets,
                         neg is not None)


def _bucket_plan(px, py, p_inf, keys, n_buckets: int, subs: tuple[int, ...],
                 bcaps: tuple[int, ...] | None = None, neg=None, stats=None):
    """The bases packed into rows, each window's keys sorted and the lane
    table built: returns (the bucket-loop kernel's arguments, the blocks of
    windows the merge takes). `_bucket_accumulate` gives the arguments."""
    lazy = neg is not None
    device = px.device
    n = px.shape[1]
    n_windows = keys.shape[0]
    assert len(subs) == n_windows
    if bcaps is None:
        bcaps = (n_buckets,) * n_windows
    packed = bn254.pack_points_dense(px, py)  # (N, 16)
    keys = torch.where(p_inf[None, :], 0, keys.to(torch.int64))
    logn = max((n - 1).bit_length(), 1)
    lane = torch.arange(n, dtype=torch.int64, device=device)
    sk = torch.sort((keys << logn) | lane[None, :], dim=1).values  # stable by lane
    sorted_keys = (sk >> logn).contiguous()
    order = sk & ((1 << logn) - 1)
    order_flat = order.reshape(-1)

    targets = torch.arange(n_buckets, dtype=torch.int64, device=device).expand(n_windows, -1)
    seg_start = torch.searchsorted(sorted_keys, targets.contiguous())
    counts = torch.searchsorted(sorted_keys, targets.contiguous(), right=True) - seg_start
    counts[:, 0] = 0  # bucket 0 contributes nothing

    # Static lane maps: windows grouped by (sub-count, bucket cap) into
    # rectangular blocks (subs, rows, bcap), flattened C-order onto one axis:
    # sub-accumulator j of neighbouring buckets are neighbouring lanes, so
    # the merge kernel's threads, a bucket each, read them coalesced.
    blocks: list[tuple[int, int, list[int]]] = []
    for w in sorted(range(n_windows), key=lambda w: (subs[w], bcaps[w])):
        if blocks and blocks[-1][:2] == (subs[w], bcaps[w]):
            blocks[-1][2].append(w)
        else:
            blocks.append((subs[w], bcaps[w], [w]))
    win_np, bkt_np, sub_np, nsub_np = [], [], [], []
    for s, bc, rows in blocks:
        nr = len(rows)
        win_np.append(np.tile(np.repeat(np.array(rows, np.int64), bc), s))
        bkt_np.append(np.tile(np.arange(bc, dtype=np.int64), nr * s))
        sub_np.append(np.repeat(np.arange(s, dtype=np.int64), nr * bc))
        nsub_np.append(np.full(nr * bc * s, s, np.int64))
    as_t = lambda parts: torch.from_numpy(np.concatenate(parts)).to(device)  # noqa: E731
    win_map, bkt_map, sub_map, nsub_map = (as_t(x) for x in (win_np, bkt_np, sub_np, nsub_np))
    n_lanes = win_map.shape[0]
    seg_l = seg_start.reshape(-1)[win_map * n_buckets + bkt_map]
    counts_l = counts.reshape(-1)[win_map * n_buckets + bkt_map]

    # additions each lane makes; order lanes by it (round r is then a lane
    # prefix, and a warp's lanes of the loop kernel finish together)
    need = pk._need(counts_l, sub_map, nsub_map)
    perm = torch.argsort(need, descending=True, stable=True)
    if stats is not None:  # a host readback, for the counts only
        for key, v in (("lanes", n_lanes), ("rounds", int(need.max())),
                       ("lane_rounds", int(need.sum()))):
            stats[key] = stats.get(key, 0) + v

    # the loop's arguments, accumulators in lane order
    table = tuple(x[perm].to(torch.int32) for x in (seg_l, counts_l, sub_map, nsub_map, win_map))
    order32, lane32 = order_flat.to(torch.int32), perm.to(torch.int32)
    if lazy:
        neg_sorted = torch.gather(neg, 1, order).reshape(-1)  # by sorted position
        return (packed, order32, neg_sorted, *table, lane32, n), blocks
    return (packed, order32, *table, lane32, n), blocks


def _bucket_loop(loop_args, lazy: bool):
    """The whole bucket loop in one launch (`_bucket_plan`'s arguments)."""
    if lazy:
        return lzp.bucket_loop_lazy(*loop_args)
    return pk.bucket_loop(*loop_args)


def _bucket_merge(acc, blocks, n_buckets: int, lazy: bool):
    """Merge each block's S sub-accumulators in a halving tree (S is a power
    of two), pad capped windows' dead buckets with infinity, restore the
    window-row order: one launch on the signed route, which also
    canonicalises; level by level of K2 on the unsigned one."""
    if lazy:
        return lzp.merge_lazy(acc, blocks, n_buckets)
    return lzp.merge_rounds(lambda lo, hi: bn254.padd(lo, hi, nodouble=True), acc, blocks,
                            n_buckets)


def _window_sums(buckets, n_buckets: int):
    """T_w = sum_b b * B_{w,b} via the suffix-sum identity: a Hillis-Steele
    suffix scan, then a Hillis-Steele reduction over the bucket axis
    (`pippenger.py:401-432`), in one launch for every row
    (`point_kernels.window_sums`). buckets: coordinates (8, W, B)."""
    assert buckets[0].shape[2] == n_buckets
    return pk.window_sums(*(c.contiguous() for c in buckets))


def msm_packed_multi(px, py, p_inf, scalars, window_bits: int | None = None,
                     s_base: int | None = None, s_cap: int | None = None,
                     signed: bool | None = None, stats: dict | None = None) -> list[ech.Point]:
    """Batched MSMs sharing one base set. scalars: (P, 8, N) standard-form
    limbs, each scalar below r; returns P host affine results. The poly axis
    folds into the window axis, so P commitments share one bucket loop; on
    the signed route a call holds at most MAX_LANES bucket lanes and takes
    the polys in groups. `signed` picks the route (default: signed on a CUDA
    tensor); `window_bits` defaults to `_signed_window_bits(N)` there and to
    8 on the unsigned route. On the signed route it must be at most 11, on
    every device: the window-sum kernel holds a row's 2^(c-1) + 1 buckets in
    a block's shared memory, at most `WINDOW_MAX_BUCKETS`, so a larger c
    raises ValueError. `s_cap` bounds the unsigned route's
    sub-accumulators only. `stats`, if given, gains the calls' bucket lanes,
    rounds (the most additions a lane makes) and lane-rounds (the additions
    of all lanes).

    The signed route relies on scalars below r: the top windows' bucket caps
    and the carry out of the top window hold only below it, and an
    unreduced scalar would lose its top bucket with no other sign. So it
    raises ValueError on a scalar whose top limb exceeds r's, which is
    enough: such a top limb keeps every capped window's key within its cap
    and the scalar below 2^254."""
    assert scalars.dim() == 3
    n_polys, n = scalars.shape[0], scalars.shape[2]
    if signed is None:
        signed = px.device.type == "cuda"
    d_base, d_cap = default_schedule(px.device)
    s_base = d_base if s_base is None else s_base
    s_cap = d_cap if s_cap is None else s_cap
    if signed:
        c = window_bits or _signed_window_bits(n)
        n_buckets, n_windows, subs, bcaps, group = _signed_plan(scalars, c, s_base)
        if n_polys > group:
            out = []
            for i in range(0, n_polys, group):
                out.extend(msm_packed_multi(px, py, p_inf, scalars[i : i + group], c, s_base,
                                            s_cap, True, stats))
            return out
        keys, neg = _signed_keys(scalars, c)  # (P, W, N) each
        buckets = _bucket_accumulate(
            px, py, p_inf, keys.reshape(n_polys * n_windows, n), n_buckets, subs * n_polys,
            bcaps * n_polys, neg.reshape(n_polys * n_windows, n), stats,
        )
    else:
        c = window_bits or 8
        keys = _keys_from_digits(scalars, c)  # (P, W, N)
        n_windows = keys.shape[1]
        n_buckets = 1 << c
        subs = _sub_schedule(n_windows, c, s_base, s_cap) * n_polys  # row = p*W + w
        buckets = _bucket_accumulate(px, py, p_inf, keys.reshape(n_polys * n_windows, n),
                                     n_buckets, subs, stats=stats)
    return _horner(_window_sums(buckets, n_buckets), n_polys, n_windows, c)


def _signed_plan(scalars, c: int, s_base: int):
    """The signed route's (n_buckets, n_windows, subs, bcaps, polys per
    call) for c-bit windows; raises ValueError on a window the window-sum
    kernel cannot hold and on a scalar not below r (see `msm_packed_multi`)."""
    n_buckets = (1 << (c - 1)) + 1
    if n_buckets > pk.WINDOW_MAX_BUCKETS:
        raise ValueError(f"signed window bits {c}: {n_buckets} buckets a window, the "
                         f"window-sum kernel's shared memory holds {pk.WINDOW_MAX_BUCKETS}")
    if scalars.shape[2] and int(u64(scalars[:, N_LIMBS - 1]).max()) > ech.R >> 224:
        raise ValueError("the signed MSM route needs scalars below r")
    n_windows = -(-256 // c)
    subs, bcaps = _sub_schedule_signed(n_windows, c, s_base)
    return n_buckets, n_windows, subs, bcaps, max(1, MAX_LANES // _lanes_per_poly(subs, bcaps))


def _horner(window_sums, n_polys: int, n_windows: int, shift: int) -> list[ech.Point]:
    """Each poly's window sums (poly-major rows) combined on the host:
    sum_w 2^(shift*w) T_w by Horner from the top window."""
    pts = bn254.unpack_jacobian(window_sums)
    out = []
    for pi in range(n_polys):
        acc = None
        for p in reversed(pts[pi * n_windows : (pi + 1) * n_windows]):
            for _ in range(shift):
                acc = ech.g1_double(acc)
            acc = ech.g1_add(acc, p)
        out.append(acc)
    return out


def msm_packed(px, py, p_inf, scalar_limbs, window_bits: int | None = None,
               signed: bool | None = None, stats: dict | None = None) -> ech.Point:
    """MSM over packed affine bases and (8, N) standard-form scalar limbs,
    each below r; the result is a host affine point."""
    return msm_packed_multi(px, py, p_inf, scalar_limbs[None], window_bits, signed=signed,
                            stats=stats)[0]


def msm(points: list[ech.Point], scalars: list[int], device="cuda",
        window_bits: int | None = None, signed: bool | None = None) -> ech.Point:
    """Convenience entry: host points + host int scalars."""
    assert len(points) == len(scalars)
    px, py, p_inf = bn254.pack_affine(points, device)
    sd = f.pack_ints([s % ech.R for s in scalars], device)
    return msm_packed(px, py, p_inf, sd, window_bits, signed)
