"""On-card profile of the MSM and Montgomery-product hot path.

Counterpart of `profile_tpu.py`:

    python -m paillier_halo2_tpu_torch.benches.profile_chip [hbm|mulmod|padd|msm ...]
        [--msm-log2 20] [--device cpu] [--params-dir DIR]

Phases (default: all four, in this order), each printing its lines on
stderr:

- `hbm`: `x + 1` over 64 and 256 MB of int32, in GB/s (read + write);
- `mulmod`: K1 (`mont_mul`) and K7 (`mont_mul_lazy`) over Fr at 2^20 lanes
  of `bench.py`'s digits: ms a call, M products/s, and the share of the
  bytes bound (96 B a product over the H100's 3.35 TB/s) the call reaches.
  `profile_tpu.py`'s sweep over the TPU kernel's `impl` and `BLOCK` has no
  counterpart: the CUDA kernels have one launch configuration;
- `padd`: K4's packed mixed add (`nodouble`) and K2's Jacobian add at 2^16
  lanes, in M adds/s;
- `msm`: the signed route over 2^N points of the seed-b"" SRS with
  `bench.py`'s scalars: the whole `msm_packed`, then its parts in order,
  each its ms and share of the whole: the window recoding (`_signed_plan`,
  `_signed_keys`), the sort and lane table (`_bucket_plan`), the bucket
  loop (`_bucket_loop`), the merge (`_bucket_merge`), the window sums
  (`_window_sums`) and the host Horner step (`_horner`), and the gap
  between the parts' sum and the whole. The whole call's point and the
  parts' must equal `params_fixtures/bench_msm_expected_{N}.json`.

On the card every time comes from a pair of `torch.cuda.Event`s around
synchronized calls (a host step inside the pair counts as the wall it
takes); on the CPU (`--device cpu`, for tests) from the host clock, and the
line says which (`timer`). Ends with one JSON line on stdout; `main`
returns it. The SRS is cached in `--params-dir` (default the repo's
`params/`).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

PHASES = ("hbm", "mulmod", "padd", "msm")
H100_SPEC_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, HBM3
BYTES_PER_PRODUCT = 3 * 32  # two (8,) int32 limb operands read, one written
MULMOD_LOG2, PADD_LOG2 = 20, 16


def card_name_and_power(device) -> str | None:
    """`nvidia-smi`'s name and power limit of the card, None on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[torch.device(device).index or 0]


class Timer:
    """Milliseconds a call: CUDA events on the card, the host clock on the
    CPU."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.kind = "cuda_events" if self.device.type == "cuda" else "host_clock"

    def ms(self, fn, reps: int = 5, warm: int = 1):
        """(mean ms over `reps` calls after `warm` calls, the last result).
        On the CPU one call, whose time says nothing of the card."""
        import torch

        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t0) * 1e3, out
        for _ in range(warm):
            out = fn()
        torch.cuda.synchronize(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / reps, out


def phase_hbm(device, timer: Timer) -> list:
    import torch

    from . import log

    out = []
    for mb in (64, 256):
        x = torch.arange(mb << 18, dtype=torch.int32, device=device)
        ms, _ = timer.ms(lambda: x + 1, reps=10)
        gbps = 2 * x.numel() * 4 / (ms * 1e-3) / 1e9
        log(f"hbm copy {mb} MB: {ms:.4f} ms -> {gbps:.1f} GB/s (read + write)")
        out.append({"mb": mb, "ms": ms, "gbps": gbps})
    return out


def phase_mulmod(device, timer: Timer) -> dict:
    import numpy as np

    from ..ff import field as f
    from ..ff import lazy_mont, mulmod
    from . import log

    n = 1 << MULMOD_LOG2
    rng = np.random.default_rng(1)
    digits = [rng.integers(0, 255, (32, n)).astype(np.uint32) for _ in range(2)]
    for d in digits:
        d[31] &= 0x1F
    a, b = (f.from_ref_digits(d, device) for d in digits)
    rng = np.random.default_rng(1)
    al, bl = (f.from_lazy_digits(f.FR, rng.integers(0, 255, (32, n)).astype(np.int16), device)
              for _ in range(2))
    bound_ms = n * BYTES_PER_PRODUCT / H100_SPEC_BYTES_PER_S * 1e3
    out = {"lanes": n, "bound_ms": bound_ms}
    for name, fn in (("mont_mul", lambda: mulmod.mont_mul(f.FR, a, b)),
                     ("mont_mul_lazy", lambda: lazy_mont.mont_mul_lazy(f.FR, al, bl))):
        ms, _ = timer.ms(fn, reps=10)
        out[name] = {"ms": ms, "m_products_per_s": n / (ms * 1e-3) / 1e6,
                     "share_of_bytes_bound": bound_ms / ms}
        log(f"{name} 2^{MULMOD_LOG2} Fr lanes: {ms:.4f} ms -> "
            f"{out[name]['m_products_per_s']:.1f} M/s, {100 * bound_ms / ms:.1f} % of the bytes "
            f"bound ({bound_ms:.4f} ms)")
    return out


def phase_padd(device, timer: Timer) -> dict:
    import random

    import numpy as np
    import torch

    from ..ec import bn254
    from ..ec import host as ech
    from . import log

    n = 1 << PADD_LOG2
    prng = random.Random(3)
    base = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(64)]
    idx = np.random.default_rng(2).integers(0, 64, n)
    px, py, _ = bn254.pack_affine([base[i] for i in idx], device)
    packed = bn254.pack_points_dense(px, py)
    one = bn254.SPEC.limbs("one_mont", device)[:, None].expand_as(px).contiguous()
    acc = (px, py, one)
    other = tuple(torch.roll(c, 1, dims=1).contiguous() for c in acc)
    q_inf = torch.zeros(n, dtype=torch.bool, device=device)
    out = {"lanes": n}
    for name, fn in (("madd_packed_nodouble", lambda: bn254.padd_mixed_packed(acc, packed, q_inf,
                                                                              nodouble=True)),
                     ("jadd", lambda: bn254.padd(acc, other))):
        ms, _ = timer.ms(fn)
        out[name] = {"ms": ms, "m_adds_per_s": n / (ms * 1e-3) / 1e6}
        log(f"{name} 2^{PADD_LOG2} lanes: {ms:.4f} ms -> {out[name]['m_adds_per_s']:.2f} M adds/s")
    return out


def phase_msm(device, timer: Timer, log2: int, params_dir: str | None) -> dict:
    from ..msm import pippenger as pip
    from ..plonk.srs import read_or_create_srs
    from . import log
    from .bench import bench_scalars, msm_expected

    n = 1 << log2
    srs = read_or_create_srs(log2, device=device, params_dir=params_dir)
    scalars, sd = bench_scalars(log2, device)
    px, py, p_inf = srs.g1_px, srs.g1_py, srs.g1_inf
    expected = msm_expected(log2, srs, scalars)
    full_ms, point = timer.ms(lambda: pip.msm_packed(px, py, p_inf, sd, signed=True))
    if point != expected:
        raise ValueError(f"msm 2^{log2}: {point} differs from the fixture's {expected}")
    log(f"msm 2^{log2} signed, whole call: {full_ms:.4f} ms -> "
        f"{n / (full_ms * 1e-3) / 1e6:.2f} M points/s; equal to the fixture")

    c = pip._signed_window_bits(n)
    s_base = pip.default_schedule(device)[0]
    scal = sd[None]

    def recode():
        plan = pip._signed_plan(scal, c, s_base)
        return plan, pip._signed_keys(scal, c)

    parts = {}
    parts["recode"], ((n_buckets, n_windows, subs, bcaps, _), (keys, neg)) = timer.ms(recode)
    keys, neg = keys.reshape(n_windows, n), neg.reshape(n_windows, n)
    parts["sort_and_lane_table"], (loop_args, blocks) = timer.ms(
        lambda: pip._bucket_plan(px, py, p_inf, keys, n_buckets, subs, bcaps, neg))
    parts["bucket_loop"], acc = timer.ms(lambda: pip._bucket_loop(loop_args, True))
    parts["merge"], buckets = timer.ms(lambda: pip._bucket_merge(acc, blocks, n_buckets, True))
    parts["window_sums"], sums = timer.ms(lambda: pip._window_sums(buckets, n_buckets))
    parts["horner"], (got,) = timer.ms(lambda: pip._horner(sums, 1, n_windows, c))
    if got != expected:
        raise ValueError(f"msm 2^{log2}: the parts' point {got} differs from the fixture's")
    total = sum(parts.values())
    for name, ms in parts.items():
        log(f"  {name}: {ms:.4f} ms ({100 * ms / full_ms:.1f} % of the whole call)")
    log(f"  sum of the parts {total:.4f} ms, gap to the whole call {full_ms - total:.4f} ms; "
        f"the parts' point equals the fixture")
    return {"log2": log2, "window_bits": c, "full_ms": full_ms, "points_per_s": n / full_ms * 1e3,
            "parts_ms": parts, "shares": {k: v / full_ms for k, v in parts.items()},
            "gap_ms": full_ms - total, "valid": True}


def run(phases=PHASES, device="cuda", msm_log2: int = 20, params_dir: str | None = None) -> dict:
    from . import check_device, log

    name = check_device(device)
    timer = Timer(device)
    card = card_name_and_power(device)
    log(f"device: {name}" + (f" ({card})" if card else "") + f"; timer: {timer.kind}")
    line = {"device": name, "card": card, "timer": timer.kind}
    for phase in phases:
        log(f"--- {phase} ---")
        if phase == "msm":
            line["msm"] = phase_msm(device, timer, msm_log2, params_dir)
        else:
            line[phase] = {"hbm": phase_hbm, "mulmod": phase_mulmod,
                           "padd": phase_padd}[phase](device, timer)
    print(json.dumps(line), flush=True)
    return line


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description="On-card profile of the MSM and mulmod hot path")
    ap.add_argument("phases", nargs="*", help=f"any of {' '.join(PHASES)} (default: all)")
    ap.add_argument("--msm-log2", type=int, default=20, help="PROF_MSM_LOG2")
    ap.add_argument("--device", default=device)
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    a = ap.parse_args(argv)
    unknown = sorted(set(a.phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    return run(a.phases or PHASES, a.device, a.msm_log2, a.params_dir)


if __name__ == "__main__":
    main()
