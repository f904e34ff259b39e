"""`msm_kernels_roofline`: the least time a commitment of N points to
b-bit scalars could take on the card, over the summed device time of every
kernel one commitment runs (hand written and PyTorch's), in percent.

The least time is a function of N and b alone, so it reads the same work
whatever implements it:

- additions: a bucket method with windows of c bits makes ceil(b/c)
  windows, each of N bucket additions and 2 * 2^c additions of its running
  sum; c is the width that makes that fewest;
- every addition at the lowest known product count, batch-affine with a
  shared inversion: 6 Fq products, 264 int32 multiply-adds each;
- bytes: each point (64 B affine) and scalar (32 B) read once, the point
  written once (64 B);
- the bound is the larger of multiply-adds over the card's int32 rate and
  bytes over its HBM rate (`peaks.json`).
"""
from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")


def bucket_additions(n_points: int, scalar_bits: int) -> int:
    return min(-(-scalar_bits // c) * (n_points + 2 * (1 << c)) for c in range(1, scalar_bits + 1))


def bound_seconds(n_points: int, scalar_bits: int, peaks: dict) -> float:
    mads = (bucket_additions(n_points, scalar_bits) * peaks["fq_products_per_point_addition"]
            * peaks["multiply_adds_per_fq_product"])
    nbytes = n_points * (64 + 32) + 64
    return max(mads / peaks["int32_multiply_adds_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def read(obs: dict):
    tr, inp = obs.get("trace"), obs.get("inputs", {})
    if not tr or not tr["steps"] or tr["kernel_s"] <= 0 or "points" not in inp:
        return None
    with open(PEAKS) as fh:
        peaks = json.load(fh)
    return 100.0 * bound_seconds(inp["points"], inp["scalar_bits"], peaks) / (tr["kernel_s"] / tr["steps"])
