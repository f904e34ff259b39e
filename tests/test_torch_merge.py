"""The signed MSM's sub-accumulator merge (`ec/lazy_point.merge_lazy`) on
the CPU: its plain version against K6's plain step (`padd_lazy_plain`)
applied level by level to each bucket's halving tree, bit for bit, on
redundant-form accumulators with infinity lanes in both encodings; the merge
kernel's thread schedule (`csrc/g1_add_lazy.cu` `g1_merge_lazy_kernel`),
modelled here symbolically from the block table the wrapper builds, against
the halving tree's own operand order; and the wrapper's input checks.

The kernel itself is held against the plain version on the card in
`test_torch_cuda.py` and by `chip_smoke.py`.
"""
import random

import numpy as np
import pytest
import torch

from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ec import lazy_point as lp
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import lazy_mont as lz
from paillier_halo2_tpu_torch.msm import pippenger as pip

Q = ech.Q
RM = (1 << 256) % Q
N_BUCKETS = 5
# (s, bcap, rows): s = 1, 2, 8, 32, 512 and 4096, capped windows (bcap < 5),
# two rows in one block, rows out of window order
BLOCKS = [(1, 3, [2]), (2, 5, [0]), (8, 4, [1, 4]), (32, 2, [3]), (4096, 1, [5]), (512, 2, [6])]


def _accumulators(blocks, seed: int):
    """Redundant-form accumulators for the layout: Jacobian points of a
    small pool with random Z, every fifth lane at infinity as (one, one, 0)
    or (0, 0, 0), and p added to a random half of the nonzero coordinates."""
    prng = random.Random(seed)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(16)]
    n_lanes = sum(s * bc * len(rows) for s, bc, rows in blocks)
    cols = ([], [], [])
    for i in range(n_lanes):
        if i % 5 == 3:
            vals = (RM, RM, 0) if i % 10 == 3 else (0, 0, 0)
        else:
            x, y = prng.choice(pool)
            z = prng.randrange(1, Q)
            vals = (x * z * z % Q * RM % Q, y * z ** 3 % Q * RM % Q, z * RM % Q)
        for c, v in zip(cols, vals):
            c.append(v + Q if v and prng.random() < 0.5 else v)
    return tuple(f.pack_ints(c, "cpu") for c in cols)


def _stepwise(acc, blocks, n_buckets):
    """Bucket by bucket, K6's plain step on the halves of its s
    sub-accumulators (lanes off + j * rows * bcap + r * bcap + b) until one
    is left, then the pipeline's exit."""
    n_rows = sum(len(rows) for _, _, rows in blocks)
    out = tuple(torch.zeros((8, n_rows, n_buckets), dtype=torch.int32) for _ in range(3))
    off = 0
    for s, bc, rows in blocks:
        rb = len(rows) * bc
        for ri, w in enumerate(rows):
            for b in range(bc):
                t = tuple(c[:, off + ri * bc + b : off + s * rb : rb] for c in acc)
                while t[0].shape[1] > 1:
                    h = t[0].shape[1] // 2
                    t = lp.padd_lazy_plain(*(c[:, :h] for c in t), *(c[:, h:] for c in t))
                for o, c in zip(out, t):
                    o[:, w, b] = lz.canonicalize(lp.SPEC, c)[:, 0]
        off += len(rows) * bc * s
    return out


def test_merge_plain_equals_stepwise_k6():
    acc = _accumulators(BLOCKS, 1)
    before = dict(lp.LAUNCHES)
    got = lp.merge_lazy(acc, BLOCKS, N_BUCKETS)  # CPU tensors: the plain version
    assert dict(lp.LAUNCHES) == before  # no kernel on the CPU
    want = _stepwise(acc, BLOCKS, N_BUCKETS)
    assert all(g.shape == (8, 7, N_BUCKETS) for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the levels through K6's wrapper, as chip_smoke.py composes them on the card
    levels = lp.canonicalize_jp(*lp.merge_rounds(lp.padd_lazy, acc, BLOCKS, N_BUCKETS))
    assert all(torch.equal(g, w) for g, w in zip(levels, want))
    z = got[2]
    assert bool((z[:, 3, 2:] == 0).all())  # a capped window's dead buckets
    assert bool((z == 0).all(dim=0).any()) and bool((z != 0).any(dim=0).any())
    assert max(max(f.unpack_ints(c.reshape(8, -1))) for c in got) < Q  # canonical


# -- the kernel's schedule, symbolically ------------------------------------------


def _subtree(first: int, stride: int, d: int):
    """The kernel's `subtree`: the leaves at lanes first + stride * i
    entered depth first at position bitrev(i), pending sums on a stack."""
    stack = {}
    for p in range(1 << d):
        i = int(format(p, f"0{d}b")[::-1], 2) if d else 0
        v = first + stride * i
        q, lvl = p, 0
        while q & 1:
            v = (stack[lvl], v)
            q, lvl = q >> 1, lvl + 1
        if p + 1 < 1 << d:
            stack[lvl] = v
    return v


def _block_tree(vals: list):
    """The kernel's `block_tree`: halving levels over the threads' values."""
    vals = list(vals)
    half = len(vals) // 2
    while half:
        vals[:half] = [(vals[t], vals[t + half]) for t in range(half)]
        half //= 2
    return vals[0]


def _kernel_model(meta, n_blocks: int, n_ctas: int, nb: int):
    """`g1_merge_lazy_kernel` CTA by CTA on symbols: a leaf is its lane, a
    sum is the pair (first operand, second). Returns {(window, bucket): the
    written value}, "zero" for a dead bucket; fails on a bucket written
    twice."""
    fields, threads = 9, lp.MERGE_THREADS
    row_list = meta[n_blocks * fields :]
    out, partial = {}, {}

    def put(key, v):
        assert key not in out, f"bucket {key} written twice"
        out[key] = v

    for cta in range(n_ctas):
        k = 0
        while k + 1 < n_blocks and meta[(k + 1) * fields + 5] <= cta:
            k += 1
        lane_off, s, bcap, rows, row_first, cta_first, slot_off, G, P = (
            int(v) for v in meta[k * fields : (k + 1) * fields])
        d = (s // G).bit_length() - 1
        rb = rows * bcap
        if P == 0:
            state = []
            for t in range(threads):
                gi = (cta - cta_first) * (threads // G) + t // G
                active, live = gi < rows * nb, gi < rb
                r, b = 0, 0
                if live:
                    r, b = divmod(gi, bcap)
                elif active:
                    r, b = divmod(gi - rb, nb - bcap)
                    b += bcap
                v = _subtree(lane_off + t % G * rb + gi, G * rb, d) if live else "zero"
                state.append([v, live, t % G, active, r, b])
            half = G >> 1
            while half:
                partner = [state[t + half if t % 32 + half < 32 else t][0] for t in range(threads)]
                for t, st in enumerate(state):
                    if st[1] and st[2] < half:
                        st[0] = (st[0], partner[t])
                half >>= 1
            for v, live, g, active, r, b in state:
                if active and g == 0:
                    put((int(row_list[row_first + r]), b), v)
            continue
        ci, live_ctas = cta - cta_first, rb * P
        if ci >= live_ctas:
            r, b = divmod(ci - live_ctas, nb - bcap)
            put((int(row_list[row_first + r]), bcap + b), "zero")
            continue
        bucket, c = divmod(ci, P)
        r, b = divmod(bucket, bcap)
        v = _block_tree([_subtree(lane_off + (c + P * t) * rb + bucket, G * rb, d)
                         for t in range(threads)])
        got = partial.setdefault(slot_off + bucket, {})
        got[c] = v
        if len(got) == P:  # the CTA that finishes the bucket last
            put((int(row_list[row_first + r]), b), _block_tree([got[i] for i in range(P)]))
    return out


def _halving_trees(blocks, nb):
    want, off = {}, 0
    for s, bc, rows in blocks:
        for ri, w in enumerate(rows):
            for b in range(nb):
                if b >= bc:
                    want[(w, b)] = "zero"
                    continue
                t = [off + j * len(rows) * bc + ri * bc + b for j in range(s)]
                while len(t) > 1:
                    h = len(t) // 2
                    t = [(t[j], t[j + h]) for j in range(h)]
                want[(w, b)] = t[0]
        off += len(rows) * bc * s
    return want


def _msm_blocks(c: int, s_base: int, n_polys: int):
    """The signed route's block layout for an MSM (`_bucket_accumulate`)."""
    n_windows = -(-256 // c)
    subs, bcaps = pip._sub_schedule_signed(n_windows, c, s_base)
    subs, bcaps = subs * n_polys, bcaps * n_polys
    blocks = []
    for w in sorted(range(len(subs)), key=lambda w: (subs[w], bcaps[w])):
        if blocks and blocks[-1][:2] == (subs[w], bcaps[w]):
            blocks[-1][2].append(w)
        else:
            blocks.append((subs[w], bcaps[w], [w]))
    return blocks, (1 << (c - 1)) + 1


@pytest.mark.parametrize("layout", ["mixed", "k14", "c10", "k20"])
def test_merge_kernel_schedule_is_the_halving_tree(layout):
    """Every bucket of the layout is written once, by the tree the halving
    levels build, operands in their order: the mixed layout above (s = 1
    to 4,096); the 2^14 MSM's (s = 8, a thread a bucket, and 32, four
    threads); c = 10 at s_base 1 (s = 1 and 64); 2^20's (s = 8, and s =
    4,096 over 8 CTAs a bucket and a last one that adds their results)."""
    if layout == "mixed":
        blocks, nb = BLOCKS, N_BUCKETS
    else:
        c, s_base = {"k14": (8, 8), "c10": (10, 1), "k20": (11, 8)}[layout]
        blocks, nb = _msm_blocks(c, s_base, 1)
    meta, n_ctas, n_slots, n_lanes, n_rows, smem_slots, parts = lp.merge_meta(blocks, nb)
    assert n_lanes == sum(s * bc * len(r) for s, bc, r in blocks)
    assert n_rows == sum(len(r) for _, _, r in blocks)
    assert n_slots == sum(len(r) * bc for s, bc, r in blocks if s > lp.MERGE_WARP_MAX_S)
    assert 1 <= smem_slots <= 3 and parts == max(s // 512 if s > 256 else 0 for s, _, _ in blocks)
    got = _kernel_model(meta, len(blocks), n_ctas, nb)
    assert got == _halving_trees(blocks, nb)
    if layout == "k20":
        assert {s for s, _, _ in blocks} == {8, 4096} and parts == 8


def test_merge_wrapper_rejects_inputs_it_does_not_take():
    blocks = [(2, 3, [1]), (4, 2, [0])]
    acc = tuple(torch.zeros((8, 14), dtype=torch.int32) for _ in range(3))
    before = dict(lp.LAUNCHES)
    assert lp.merge_lazy(acc, blocks, 3)[0].shape == (8, 2, 3)
    with pytest.raises(TypeError):
        lp.merge_lazy((acc[0], acc[1], acc[2].to(torch.int64)), blocks, 3)
    with pytest.raises(ValueError):  # one lane short of the layout
        lp.merge_lazy(tuple(c[:, :13].contiguous() for c in acc), blocks, 3)
    with pytest.raises(ValueError):
        lp.merge_lazy((acc[0], acc[1], acc[2].to("meta")), blocks, 3)
    with pytest.raises(ValueError, match="block"):  # s not a power of two
        lp.merge_lazy(acc, [(3, 2, [1]), (4, 2, [0])], 3)
    with pytest.raises(ValueError, match="block"):  # a cap above the bucket count
        lp.merge_lazy(acc, [(2, 3, [1]), (2, 4, [0])], 3)
    with pytest.raises(ValueError, match="rows"):  # window 1 twice, window 0 never
        lp.merge_lazy(acc, [(2, 3, [1]), (4, 2, [1])], 3)
    assert dict(lp.LAUNCHES) == before
    assert np.array_equal(lp.merge_meta(blocks, 3)[0][-2:], [1, 0])
