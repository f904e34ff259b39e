#!/usr/bin/env python3
"""Time one checkout's step kernels on the card, for comparing two checkouts
of the port in one run (A, B, B, A).

    python3 paillier_halo2_tpu_torch/probes/kernel_ab.py --label new
    python3 paillier_halo2_tpu_torch/probes/kernel_ab.py --root DIR --label parent

`--root` names the checkout whose `paillier_halo2_tpu_torch` is imported and
built (into its own `build/kernels/`); by default, the one holding this file.
It times, by torch.profiler device time per launch, on the same seeded
inputs in every checkout:

- K1 `mont_mul` and K7 `mont_mul_lazy`, Fr, 2^16 lanes;
- K3 `g1_madd` (full), K4 `g1_madd_packed` (nodouble) and K6 `padd_lazy`,
  2^14 lanes;
- K6 at the lane counts of the merge levels of the k=14 proof's first MSM
  call (62 polys, c = 8), and K3 at 2^20 lanes, the SRS comb's step there;
- where the checkout has them, the comb kernel (`fixed_base_comb`) at 2^14
  and 2^20 scalars and the merge kernel (`merge_lazy`) at the first MSM
  call's layout and at 2^20's.

Inputs are field values below 2^252 (not curve points: the formulas' work
and bits do not depend on that), made on the CPU from a seed. Each output's
blake2b digest is printed beside its time, so two checkouts' bits can be
compared. Prints one JSON line; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="checkout whose package to time")
    ap.add_argument("--label", default="", help="name printed with the results")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab: no CUDA device")
    from paillier_halo2_tpu_torch.ec import lazy_point as lp
    from paillier_halo2_tpu_torch.ec import point_kernels as pk
    from paillier_halo2_tpu_torch.ff import field as f
    from paillier_halo2_tpu_torch.ff import lazy_mont as lz
    from paillier_halo2_tpu_torch.ff import mulmod
    from paillier_halo2_tpu_torch.utils import kernels

    dev = torch.device("cuda", 0)
    kernels.lib()
    gen = torch.Generator().manual_seed(7)

    def field_values(n: int):
        x = torch.randint(-(1 << 31), 1 << 31, (8, n), dtype=torch.int64, generator=gen)
        x[7] &= 0x0FFFFFFF  # below 2^252 < p for Fr and Fq
        return x.to(torch.int32).to(dev)

    def timed(fn, kernel: str, iters: int = 10):
        """(device us per launch of the CUDA symbol containing `kernel`,
        launches per call, digest of one call's outputs)."""
        out = fn()
        torch.cuda.synchronize()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        digest = hashlib.blake2b(b"".join(o.cpu().numpy().tobytes() for o in outs),
                                 digest_size=8).hexdigest()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            if kernel in e.key and us > 0:
                total, count = total + us, count + e.count
        return {"device_us": total / count if count else None, "launches_per_call": count / iters,
                "digest": digest}

    res = {}
    n16, n14 = 1 << 16, 1 << 14
    a, b = field_values(n16), field_values(n16)
    res["K1 mont_mul Fr 2^16"] = timed(lambda: mulmod.mont_mul(f.FR, a, b), "mont_mul_kernel")
    res["K7 mont_mul_lazy Fr 2^16"] = timed(lambda: lz.mont_mul_lazy(f.FR, a, b),
                                            "mont_mul_lazy_kernel")
    P = tuple(field_values(n14) for _ in range(3))
    Q = tuple(field_values(n14) for _ in range(3))
    q_inf = torch.zeros(n14, dtype=torch.bool, device=dev)
    q_inf[::97] = True
    packed = torch.cat([Q[0], Q[1]]).t().contiguous()
    res["K3 g1_madd 2^14"] = timed(lambda: pk.g1_madd(*P, Q[0], Q[1], q_inf),
                                   "g1_madd_kernel<false, false>")
    res["K4 g1_madd_packed nodouble 2^14"] = timed(
        lambda: pk.g1_madd_packed(*P, packed, q_inf, nodouble=True), "g1_madd_kernel<true, true>")
    res["K6 padd_lazy 2^14"] = timed(lambda: lp.padd_lazy(P, Q), "g1_jadd_lazy_kernel")

    # the k=14 proof's first MSM call: c = 8, s = 8 for 31 windows (129
    # buckets), s = 32 for the top one (51 buckets), 62 polys
    levels = [62 * 31 * 129 * h for h in (4, 2, 1)] + [62 * 51 * h for h in (16, 8, 4, 2, 1)]
    big = tuple(field_values(levels[0]) for _ in range(6))
    for lanes in levels:
        lo = tuple(c[:, :lanes].contiguous() for c in big[:3])
        hi = tuple(c[:, :lanes].contiguous() for c in big[3:])
        res[f"K6 padd_lazy {lanes}"] = timed(lambda: lp.padd_lazy(lo, hi), "g1_jadd_lazy_kernel", 3)
    del big
    n20 = 1 << 20
    P20 = tuple(field_values(n20) for _ in range(5))
    inf20 = torch.zeros(n20, dtype=torch.bool, device=dev)
    res["K3 g1_madd 2^20"] = timed(lambda: pk.g1_madd(*P20, inf20), "g1_madd_kernel<false, false>", 3)
    del P20

    if hasattr(pk, "fixed_base_comb"):
        table = torch.cat([field_values(8192), field_values(8192)]).t().contiguous()
        table_inf = torch.zeros(8192, dtype=torch.bool, device=dev)
        table_inf[::256] = True  # digit 0 of every window
        for log_n in (14, 20):
            sd = field_values(1 << log_n)
            res[f"comb 2^{log_n}"] = timed(lambda: pk.fixed_base_comb(table, table_inf, sd),
                                           "g1_fixed_base_comb_kernel", 3)
    if hasattr(lp, "merge_lazy"):
        layouts = {
            "merge first MSM call": ([(8, 129, list(range(62 * 31))),
                                      (32, 51, list(range(62 * 31, 62 * 32)))], 129),
            "merge 2^20": ([(8, 1025, list(range(23))), (4096, 4, [23])], 1025),
        }
        for name, (blocks, nb) in layouts.items():
            n_lanes = sum(s * bc * len(r) for s, bc, r in blocks)
            acc = tuple(field_values(n_lanes) for _ in range(3))
            res[name] = timed(lambda: lp.merge_lazy(acc, blocks, nb), "g1_merge_lazy_kernel", 3)
            del acc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": opts.label, "root": opts.root, "card": smi, "kernels": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
