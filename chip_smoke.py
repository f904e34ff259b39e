#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases 1,2    # build the kernels and check them only

Phases:

1. print the card's name and power limit, then build the CUDA kernels from
   `paillier_halo2_tpu_torch/csrc/` (one nvcc per source, all at once, sm_90a)
   and print the build time;
2. hold every kernel against its plain PyTorch version on the card, exactly,
   at the main path's shapes (2^16 lanes for the Montgomery products, 2^14
   for the point adds) with edge lanes, and time both; the redundant-form
   kernels K5-K7, canonicalised, also equal K4, K2 and K1 on the same inputs;
3. a 2^14-point MSM on the seed-b"" SRS equals
   `params_fixtures/bench_msm_expected_14.json` on both routes: signed
   windows (K5, K6) and unsigned windows (K4, whose launches are counted here);
4. the K=10 encryption proof, its commitments on the signed route, is
   byte-identical to the JAX package's fixture
   `tests/torch_fixtures/slice_enc_k10.json`, and the verifier accepts it and
   rejects a tampered copy;
5. the main path: `base_test().bench_builder` on the ENC=128/LIMB=64
   encryption circuit at k=14, lookup_bits=13 — SRS generated on the card
   into a fresh directory, keygen, witness, proof, verify — with every
   kernel's launch count taken over this run alone;
6. the MSM 2^20 entry (bench.py's headline phase): the seed-b"" SRS generated
   at k = 20 on the card, bench.py's scalars, the signed route (c = 11) and
   the unsigned route (window 8), each equal to
   `params_fixtures/bench_msm_expected_20.json`, with first and warm times;
   one K5 and one K6 launch of the signed route, at their real lane counts,
   are held against their plain versions on the same inputs;
7. the lazy-mulmod entry (bench.py's `mulmod_lazy` phase): ten chained K7
   products over Fr at 2^20 lanes, equal after canonicalisation to the same
   chain through K1; K7's launches are counted here.

It needs a CUDA device and fails at once without one. Every failure raises.
Before the last line it prints one JSON object with each kernel's launch
count (over the path that runs it), error, times and bound; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Build outputs and the SRS cache go under `build/` in this checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "mont_mul": ("paillier_halo2_tpu_torch/csrc/mont_mul.cu",
                 "paillier_halo2_tpu/ff/pallas_mulmod.py:372"),
    "g1_jadd": ("paillier_halo2_tpu_torch/csrc/g1_add.cu",
                "paillier_halo2_tpu/ec/pallas_point.py:230"),
    "g1_madd": ("paillier_halo2_tpu_torch/csrc/g1_add.cu",
                "paillier_halo2_tpu/ec/pallas_point.py:265"),
    "g1_madd_packed": ("paillier_halo2_tpu_torch/csrc/g1_add.cu",
                       "paillier_halo2_tpu/ec/pallas_point.py:309"),
    "padd_mixed_packed_lazy": ("paillier_halo2_tpu_torch/csrc/g1_add_lazy.cu",
                               "paillier_halo2_tpu/ec/lazy_point.py:172"),
    "padd_lazy": ("paillier_halo2_tpu_torch/csrc/g1_add_lazy.cu",
                  "paillier_halo2_tpu/ec/lazy_point.py:220"),
    "mont_mul_lazy": ("paillier_halo2_tpu_torch/csrc/mont_mul_lazy.cu",
                      "paillier_halo2_tpu/ff/lazy_mont.py:301"),
}
# The least time the card could take for a timed call: the larger of its
# bytes over the memory rate and its 32-bit integer multiply-adds over the
# integer rate. Bytes: each input read once, each output written once.
# Operations: 264 multiply-adds per Montgomery product (8 x 8 limb products
# for a*b and for m*p, lo and hi halves counted apart, and 8 for m); the
# adds, carries and selects around them are not counted, so the bound is
# low. Rate: 64 such operations per SM per clock (CUDA C Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) times the SMs
# and the card's maximum SM clock, both read in this run.
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
IMAD_PER_PRODUCT = 264
IMAD_PER_SM_CLOCK = 64
# name -> (Montgomery products per lane, extra products per doubling lane,
#          bytes per lane)
WORK = {
    "mont_mul": (1, 0, 3 * 32),
    "mont_mul_lazy": (1, 0, 3 * 32),
    "g1_jadd": (16, 7, 6 * 32 + 3 * 32),
    "padd_lazy": (16, 0, 6 * 32 + 3 * 32),
    "g1_madd": (11, 7, 5 * 32 + 1 + 3 * 32),
    "g1_madd_packed": (11, 7, 3 * 32 + 64 + 1 + 3 * 32),
    "padd_mixed_packed_lazy": (11, 0, 3 * 32 + 64 + 2 + 3 * 32),
}
MAIN_K, MAIN_LOOKUP_BITS, MAIN_ENC, MAIN_LIMB = 14, 13, 128, 64


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str):
    """Mean device time in ms of one launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `iters` calls; None if the
    profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if kernel in e.key and us > 0:
            total, count = total + us, count + e.count
    return total / count / 1e3 if count else None


PROFILED = {  # kernel -> substring of its CUDA symbol in the profiler's rows
    "K1 mont_mul": "mont_mul_kernel", "K2 g1_jadd": "g1_jadd_kernel",
    "K3 g1_madd": "g1_madd_kernel<false, false>", "K3 g1_madd nodouble": "g1_madd_kernel<true, false>",
    "K4 g1_madd_packed": "g1_madd_kernel<true, true>", "K5 padd_mixed_packed_lazy": "g1_madd_lazy_kernel",
    "K6 padd_lazy": "g1_jadd_lazy_kernel", "K7 mont_mul_lazy": "mont_mul_lazy_kernel",
}


def profile_call(fn, wall_s: float) -> str:
    """Run fn once under torch.profiler; describe the device time of all its
    kernels (every CUDA row), their busy share of `wall_s` (the same call's
    unprofiled wall time: the profiler slows the host), and each port
    kernel's launches and device time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us, rows = 0.0, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        total_us += us
        for label, sym in PROFILED.items():
            if sym in e.key:
                c, t = rows.get(label, (0, 0.0))
                rows[label] = (c + e.count, t + us)
    parts = [f"{label} {c} launches, {t / c / 1e3:.6f} ms each" for label, (c, t) in rows.items()]
    return (f"device {total_us / 1e3:.3f} ms, busy share {total_us / 1e6 / wall_s:.3f} of "
            f"{wall_s:.4f} s; " + "; ".join(parts))


def max_abs_err(outs, refs) -> int:
    """Largest |kernel - plain| over every uint32 limb of every output."""
    import torch

    err = 0
    for o, r in zip(outs, refs):
        d = (o.to(torch.int64) & 0xFFFFFFFF) - (r.to(torch.int64) & 0xFFFFFFFF)
        err = max(err, int(d.abs().max().item()) if d.numel() else 0)
    return err


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# -- phase 2: kernels against their plain versions ---------------------------------


def check_mont_mul(dev, results: dict) -> None:
    import numpy as np
    import torch

    from paillier_halo2_tpu_torch.ff import field as f
    from paillier_halo2_tpu_torch.ff import mulmod

    n = 1 << 16
    rng = np.random.default_rng(2)
    entry = {"max_abs_err": 0}
    for spec in (f.FR, f.FQ):
        edge = [0, 1, spec.p - 1, spec.p - 2, spec.r_mod_p]
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        xs = [int.from_bytes(np.asarray(w, np.uint32).tobytes(), "little") % spec.p for w in words]
        ys = xs[1:] + xs[:1]
        for i, (u, v) in enumerate((u, v) for u in edge for v in edge):
            xs[i], ys[i] = u, v
        a, b = f.pack_ints(xs, dev), f.pack_ints(ys, dev)
        out = mulmod.mont_mul(spec, a, b)
        ref = mulmod.mont_mul_plain(spec, a, b)
        torch.cuda.synchronize()
        err = max_abs_err([out], [ref])
        require(torch.equal(out, ref), f"mont_mul({spec.name}) differs from its plain version")
        rinv = pow(1 << 256, -1, spec.p)
        got = f.unpack_ints(out[:, :64])
        require(got == [x * y * rinv % spec.p for x, y in zip(xs[:64], ys[:64])],
                f"mont_mul({spec.name}) differs from Python ints")
        ms = cuda_ms(lambda: mulmod.mont_mul(spec, a, b), 50)
        plain_ms = cuda_ms(lambda: mulmod.mont_mul_plain(spec, a, b), 5)
        dev_ms = device_ms(lambda: mulmod.mont_mul(spec, a, b), 20, f"mont_mul_kernel<pht::{spec.name}>")
        log(f"  mont_mul {spec.name} 2^16 lanes: equal, kernel {ms} ms per call "
            f"({dev_ms} ms on the device), plain {plain_ms} ms")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if spec is f.FR:  # the prover's field: the main path's bulk of products
            entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, lanes=n, double_lanes=0)
    results["mont_mul"] = entry


def _point_lanes(n: int, seed: int):
    """n host lanes of (P, Q) pairs with edge cases at the front:
    P+inf, inf+Q, P+P, P+(-P), inf+inf; the rest random distinct points."""
    from paillier_halo2_tpu_torch.ec import host as ech

    prng = random.Random(seed)
    pool = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(256)]
    ps = [pool[prng.randrange(256)] for _ in range(n)]
    qs = [pool[prng.randrange(256)] for _ in range(n)]
    for i in range(n):  # keep generic lanes generic
        while qs[i] == ps[i] or qs[i] == ech.g1_neg(ps[i]):
            qs[i] = pool[prng.randrange(256)]
    p0 = pool[0]
    edges = [(p0, None), (None, p0), (p0, p0), (p0, ech.g1_neg(p0)), (None, None)]
    for i, (p, q) in enumerate(edges):
        ps[i], qs[i] = p, q
    return ps, qs, len(edges)


def _jacobian_random_z(points, dev, seed: int):
    """Host affine points -> Jacobian Montgomery tensors with random Z (Z = 0
    and X = Y = 0 for infinity)."""
    from paillier_halo2_tpu_torch.ec import bn254
    from paillier_halo2_tpu_torch.ff import field as f

    q, rm = bn254.SPEC.p, bn254.SPEC.r_mod_p
    prng = random.Random(seed)
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(0), ys.append(0), zs.append(0)
            continue
        z = prng.randrange(1, q)
        xs.append(p[0] * z * z % q * rm % q)
        ys.append(p[1] * z * z * z % q * rm % q)
        zs.append(z * rm % q)
    return tuple(f.pack_ints(v, dev) for v in (xs, ys, zs))


def check_points(dev, results: dict) -> None:
    import torch

    from paillier_halo2_tpu_torch.ec import bn254
    from paillier_halo2_tpu_torch.ec import host as ech
    from paillier_halo2_tpu_torch.ec import point_kernels as pk

    n = 1 << 14
    ps, qs, n_edge = _point_lanes(n, 3)
    P = _jacobian_random_z(ps, dev, 4)
    Q = _jacobian_random_z(qs, dev, 5)
    qx, qy, q_inf = bn254.pack_affine(qs, dev)
    packed = bn254.pack_points_dense(qx, qy)
    want = [ech.g1_add(p, q) for p, q in zip(ps[:64], qs[:64])]

    cases = {
        "g1_jadd": (pk.g1_jadd, pk.g1_jadd_plain, (*P, *Q)),
        "g1_madd": (pk.g1_madd, pk.g1_madd_plain, (*P, qx, qy, q_inf)),
        "g1_madd_packed": (pk.g1_madd_packed, pk.g1_madd_packed_plain, (*P, packed, q_inf)),
    }
    # the variant the main path runs most, and its kernel's name
    timed_variant = {"g1_jadd": False, "g1_madd": False, "g1_madd_packed": True}
    kernel_name = {
        ("g1_jadd", False): "g1_jadd_kernel<false>", ("g1_jadd", True): "g1_jadd_kernel<true>",
        ("g1_madd", False): "g1_madd_kernel<false, false>",
        ("g1_madd", True): "g1_madd_kernel<true, false>",
        ("g1_madd_packed", False): "g1_madd_kernel<false, true>",
        ("g1_madd_packed", True): "g1_madd_kernel<true, true>",
    }
    for name, (kern, plain, args) in cases.items():
        entry = {"max_abs_err": 0}
        for nodouble in (False, True):
            out = kern(*args, nodouble=nodouble)
            ref = plain(*args, nodouble=nodouble)
            torch.cuda.synchronize()
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs_err(out, ref))
            require(all(torch.equal(o, r) for o, r in zip(out, ref)),
                    f"{name}(nodouble={nodouble}) differs from its plain version")
            got = bn254.unpack_jacobian(tuple(c[:, :64] for c in out))
            if nodouble:
                # P+P and P+(-P) break the contract: they degrade to infinity
                require(got[2] is None and got[3] is None, f"{name} nodouble: P+-P not Z=0")
                require(got[:2] + got[4:] == want[:2] + want[4:], f"{name} nodouble: wrong sum")
            else:
                require(got == want, f"{name}: sums differ from the host oracle")
            ms = cuda_ms(lambda: kern(*args, nodouble=nodouble), 50)
            plain_ms = cuda_ms(lambda: plain(*args, nodouble=nodouble), 3)
            dev_ms = device_ms(lambda: kern(*args, nodouble=nodouble), 20,
                               kernel_name[(name, nodouble)])
            log(f"  {name} nodouble={nodouble} 2^14 lanes ({n_edge} edge lanes): equal, "
                f"kernel {ms} ms per call ({dev_ms} ms on the device), plain {plain_ms} ms")
            if nodouble == timed_variant[name]:
                # the full add needs the doubling on the one P+P edge lane
                entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, lanes=n,
                             double_lanes=0 if nodouble else 1)
        results[name] = entry


def _redundant(t, spec, seed: int):
    """Add p to the nonzero values of a random half of the lanes: the same
    values mod p, in [0, 2p), and exact zeros stay zero."""
    import torch

    from paillier_halo2_tpu_torch.ff import field as f

    g = torch.Generator().manual_seed(seed)
    pick = torch.rand(t.shape[1], generator=g).to(t.device) < 0.5
    vals = f.unpack_ints(t)
    bumped = f.pack_ints([v + spec.p if v else 0 for v in vals], t.device)
    return torch.where(pick & (t != 0).any(dim=0), bumped, t)


def check_mont_mul_lazy(dev, results: dict) -> None:
    """K7 against its plain version on values in [0, 2p) with the edges 0, 1,
    p - 1, p and 2p - 1; canonicalised, against K1 on the same inputs."""
    import numpy as np
    import torch

    from paillier_halo2_tpu_torch.ff import field as f
    from paillier_halo2_tpu_torch.ff import lazy_mont as lz
    from paillier_halo2_tpu_torch.ff import mulmod

    n = 1 << 16
    rng = np.random.default_rng(6)
    entry = {"max_abs_err": 0}
    for spec in (f.FR, f.FQ):
        p = spec.p
        edge = [0, 1, p - 1, p, 2 * p - 1]
        words = rng.integers(0, 1 << 32, size=(2, n, 8), dtype=np.uint64)
        xs, ys = ([int.from_bytes(np.asarray(w, np.uint32).tobytes(), "little") % (2 * p)
                   for w in half] for half in words)
        for i, (u, v) in enumerate((u, v) for u in edge for v in edge):
            xs[i], ys[i] = u, v
        a, b = f.pack_ints(xs, dev), f.pack_ints(ys, dev)
        out = lz.mont_mul_lazy(spec, a, b)
        ref = lz.mont_mul_lazy_plain(spec, a, b)
        torch.cuda.synchronize()
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs_err([out], [ref]))
        require(torch.equal(out, ref), f"mont_mul_lazy({spec.name}) differs from its plain version")
        require(max(f.unpack_ints(out)) < 2 * p, f"mont_mul_lazy({spec.name}) left [0, 2p)")
        require(torch.equal(lz.canonicalize(spec, out), mulmod.mont_mul(spec, a, b)),
                f"mont_mul_lazy({spec.name}) canonicalised differs from mont_mul")
        rinv = pow(1 << 256, -1, p)
        got = f.unpack_ints(out[:, :64])
        require(all(g % p == x * y * rinv % p for g, x, y in zip(got, xs, ys)),
                f"mont_mul_lazy({spec.name}) differs from Python ints")
        ms = cuda_ms(lambda: lz.mont_mul_lazy(spec, a, b), 50)
        plain_ms = cuda_ms(lambda: lz.mont_mul_lazy_plain(spec, a, b), 5)
        dev_ms = device_ms(lambda: lz.mont_mul_lazy(spec, a, b), 20,
                           f"mont_mul_lazy_kernel<pht::{spec.name}>")
        log(f"  mont_mul_lazy {spec.name} 2^16 lanes: equal, canonical = mont_mul, kernel {ms} "
            f"ms per call ({dev_ms} ms on the device), plain {plain_ms} ms")
        if spec is f.FR:
            entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, lanes=n, double_lanes=0)
    results["mont_mul_lazy"] = entry


def check_lazy_points(dev, results: dict) -> None:
    """K5 and K6 on redundant-form accumulators against their plain versions
    and the host oracle; canonicalised on canonical inputs, K5 (neg unset)
    against K4 nodouble and K6 against K2 nodouble."""
    import torch

    from paillier_halo2_tpu_torch.ec import bn254
    from paillier_halo2_tpu_torch.ec import host as ech
    from paillier_halo2_tpu_torch.ec import lazy_point as lp
    from paillier_halo2_tpu_torch.ec import point_kernels as pk

    n = 1 << 14
    spec = bn254.SPEC
    ps, qs, _ = _point_lanes(n, 7)
    neg = [False] * n
    mask = [False] * n
    p0, p1 = ps[10], qs[10]
    # K5's edge lanes: acc at infinity; mask_off; neg; neg on a masked lane;
    # P + P and P + (-P) (both degrade to Z = 0 mod p); infinity + masked;
    # infinity + (-Q)
    k5_edges = [(None, p1, 0, 0), (p0, p1, 1, 0), (p0, p1, 0, 1), (p0, p1, 1, 1),
                (p0, p0, 0, 0), (p0, p0, 0, 1), (None, p1, 1, 0), (None, p1, 0, 1)]
    for i, (p, q, m, ng) in enumerate(k5_edges):
        ps[i], qs[i], mask[i], neg[i] = p, q, bool(m), bool(ng)
    P = _jacobian_random_z(ps, dev, 8)
    qx, qy, _ = bn254.pack_affine(qs, dev)
    packed = bn254.pack_points_dense(qx, qy)
    mask_t = torch.tensor(mask, device=dev)
    neg_t = torch.tensor(neg, device=dev)
    acc = tuple(_redundant(c, spec, 9 + i) for i, c in enumerate(P))

    entry = {"max_abs_err": 0}
    args = (*acc, packed, mask_t, neg_t)
    out = lp.padd_mixed_packed_lazy(*args)
    ref = lp.padd_mixed_packed_lazy_plain(*args)
    torch.cuda.synchronize()
    entry["max_abs_err"] = max_abs_err(out, ref)
    require(all(torch.equal(o, r) for o, r in zip(out, ref)),
            "padd_mixed_packed_lazy differs from its plain version")
    got = bn254.unpack_jacobian(tuple(c[:, :64] for c in lp.canonicalize_jp(*out)))
    want = []
    for i in range(64):
        p, q = ps[i], (ech.g1_neg(qs[i]) if neg[i] else qs[i])
        want.append(p if mask[i] else (None if i in (4, 5) else ech.g1_add(p, q)))
    require(got == want, "padd_mixed_packed_lazy: sums differ from the host oracle")
    # canonical inputs, neg unset: equal to K4 nodouble with mask_off as q_inf
    no_neg = torch.zeros_like(neg_t)
    lazy = lp.canonicalize_jp(*lp.padd_mixed_packed_lazy(*P, packed, mask_t, no_neg))
    k4 = pk.g1_madd_packed(*P, packed, mask_t, nodouble=True)
    require(all(torch.equal(a, b) for a, b in zip(lazy, k4)),
            "padd_mixed_packed_lazy canonicalised differs from g1_madd_packed nodouble")
    ms = cuda_ms(lambda: lp.padd_mixed_packed_lazy(*args), 50)
    plain_ms = cuda_ms(lambda: lp.padd_mixed_packed_lazy_plain(*args), 3)
    dev_ms = device_ms(lambda: lp.padd_mixed_packed_lazy(*args), 20, "g1_madd_lazy_kernel")
    log(f"  padd_mixed_packed_lazy 2^14 lanes ({len(k5_edges)} edge lanes): equal, "
        f"canonical = g1_madd_packed nodouble, kernel {ms} ms per call ({dev_ms} ms on the "
        f"device), plain {plain_ms} ms")
    entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, lanes=n, double_lanes=0)
    results["padd_mixed_packed_lazy"] = entry

    # K6: P + inf, inf + Q, P + P, P + (-P), inf + inf first (_point_lanes)
    ps, qs, n_edge = _point_lanes(n, 11)
    P = _jacobian_random_z(ps, dev, 12)
    Q = _jacobian_random_z(qs, dev, 13)
    one = spec.limbs("one_mont", dev)[:, None]
    p_inf = (P[2] == 0).all(dim=0)  # P's infinities as (one, one, 0), Q's as (0, 0, 0)
    P = (torch.where(p_inf, one, P[0]), torch.where(p_inf, one, P[1]), P[2])
    P2 = tuple(_redundant(c, spec, 14 + i) for i, c in enumerate(P))
    Q2 = tuple(_redundant(c, spec, 17 + i) for i, c in enumerate(Q))
    entry = {"max_abs_err": 0}
    out = lp.padd_lazy(P2, Q2)
    ref = lp.padd_lazy_plain(*P2, *Q2)
    torch.cuda.synchronize()
    entry["max_abs_err"] = max_abs_err(out, ref)
    require(all(torch.equal(o, r) for o, r in zip(out, ref)), "padd_lazy differs from its plain version")
    can = lp.canonicalize_jp(*out)
    got = bn254.unpack_jacobian(tuple(c[:, :64] for c in can))
    want = [None if i in (2, 3) else ech.g1_add(p, q) for i, (p, q) in enumerate(zip(ps[:64], qs[:64]))]
    require(got == want, "padd_lazy: sums differ from the host oracle")
    both_inf = 4  # the inf + inf lane: K6 takes X, Y from P, K2 from Q
    require(all(torch.equal(c[:, both_inf], p[:, both_inf]) for c, p in zip(can[:2], P)),
            "padd_lazy: inf + inf does not keep P's X, Y")
    k2 = pk.g1_jadd(*P, *Q, nodouble=True)
    lazy = lp.canonicalize_jp(*lp.padd_lazy(P, Q))
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[both_inf] = False
    require(all(torch.equal(a[:, keep], b[:, keep]) for a, b in zip(lazy, k2)),
            "padd_lazy canonicalised differs from g1_jadd nodouble")
    ms = cuda_ms(lambda: lp.padd_lazy(P2, Q2), 50)
    plain_ms = cuda_ms(lambda: lp.padd_lazy_plain(*P2, *Q2), 3)
    dev_ms = device_ms(lambda: lp.padd_lazy(P2, Q2), 20, "g1_jadd_lazy_kernel")
    log(f"  padd_lazy 2^14 lanes ({n_edge} edge lanes): equal, canonical = g1_jadd nodouble "
        f"off inf + inf, kernel {ms} ms per call ({dev_ms} ms on the device), plain {plain_ms} ms")
    entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, lanes=n, double_lanes=0)
    results["padd_lazy"] = entry


# -- phases 3-5 ---------------------------------------------------------------------


def zero_counts() -> None:
    from paillier_halo2_tpu_torch.ec import lazy_point, point_kernels
    from paillier_halo2_tpu_torch.ff import lazy_mont, mulmod

    for counts in (mulmod.LAUNCHES, point_kernels.LAUNCHES, lazy_point.LAUNCHES,
                   lazy_mont.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    import torch

    from paillier_halo2_tpu_torch.ec import lazy_point, point_kernels
    from paillier_halo2_tpu_torch.ff import lazy_mont, mulmod

    torch.cuda.synchronize()
    return {**mulmod.LAUNCHES, **point_kernels.LAUNCHES, **lazy_point.LAUNCHES,
            **lazy_mont.LAUNCHES}


def bench_scalars(k: int, dev):
    """bench.py's MSM scalar stream (`np.random.default_rng(1)`, bench.py:287-292)."""
    import numpy as np

    from paillier_halo2_tpu_torch.ec import host as ech
    from paillier_halo2_tpu_torch.ff import field as f

    rng = np.random.default_rng(1)
    hi = rng.integers(0, 2**63, (4, 1 << k), dtype=np.int64)
    scalars = [(int(x) | int(y) << 63 | int(z) << 126 | int(w) << 189) % ech.R
               for x, y, z, w in zip(*hi)]
    return f.pack_ints(scalars, dev)


def msm_fixture(k: int):
    with open(os.path.join(ROOT, "params_fixtures", f"bench_msm_expected_{k}.json")) as fh:
        ex, ey = json.load(fh)
    return int(ex, 16), int(ey, 16)


def check_msm(dev) -> dict:
    """The 2^14 MSM on both routes; returns the launches of the unsigned
    route's run, the one that runs K4."""
    import torch

    from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    k = 14
    srs = generate_srs(k, b"", dev)
    sd = bench_scalars(k, dev)
    want = msm_fixture(k)
    counts = {}
    for signed in (True, False):
        msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd, signed=signed)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.monotonic()
        got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd, signed=signed)
        counts[signed] = read_counts()
        dt = time.monotonic() - t0
        route = "signed" if signed else "unsigned"
        require(got == want, f"2^14 MSM ({route}) differs from its fixture")
        log(f"  MSM 2^14 {route} equals params_fixtures/bench_msm_expected_14.json; warm {dt:.4f} s")
    require(counts[True]["padd_mixed_packed_lazy"] > 0 and counts[True]["padd_lazy"] > 0,
            "the signed route did not launch K5 and K6")
    require(counts[False]["g1_madd_packed"] > 0, "the unsigned route did not launch K4")
    return counts[False]


def check_slice_fixture(dev) -> None:
    from paillier_halo2_tpu_torch.gadgets.context import Context
    from paillier_halo2_tpu_torch.gadgets.range import RangeChip
    from paillier_halo2_tpu_torch.harness.circuits import (
        PaillierEncryptionInput,
        paillier_enc_test,
    )
    from paillier_halo2_tpu_torch.plonk.keygen import keygen
    from paillier_halo2_tpu_torch.plonk.prover import create_proof
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    with open(os.path.join(ROOT, "tests", "torch_fixtures", "slice_enc_k10.json")) as fh:
        fx = json.load(fh)
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"],
                                  **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    table = ctx.finalize()
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), dev)
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs)
    proof = create_proof(pk, table, fx["blinding_seed"].encode())
    require(proof.hex() == fx["proof_hex"], "K=10 proof differs from the JAX fixture")
    require(verify_proof(pk.vk, srs, proof), "K=10 proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify_proof(pk.vk, srs, bytes(bad)), "tampered K=10 proof verifies")
    log(f"  K=10 proof: {len(proof)} bytes, byte-identical to the JAX fixture, verified; "
        "tampered copy rejected")


def main_input():
    from paillier_halo2_tpu_torch.bignum.host import paillier_enc_native
    from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput

    prng = random.Random(14)  # bench.py's proof-phase inputs
    n = prng.getrandbits(MAIN_ENC) | (1 << (MAIN_ENC - 1)) | 1
    g, m, r = (prng.getrandbits(MAIN_ENC) for _ in range(3))
    return PaillierEncryptionInput(enc_bits=MAIN_ENC, limb_bits=MAIN_LIMB, n=n, g=g, m=m, r=r,
                                   res=paillier_enc_native(n, g, m, r))


def run_main_path(dev, params_dir: str):
    from paillier_halo2_tpu_torch.harness.base_test import base_test
    from paillier_halo2_tpu_torch.harness.circuits import paillier_enc_test

    inp = main_input()
    tester = (base_test().k(MAIN_K).lookup_bits(MAIN_LOOKUP_BITS).expect_satisfied(True)
              .device(dev).params_dir(params_dir))
    return tester.bench_builder(inp, inp, paillier_enc_test)


def check_srs_cache(dev, params_dir: str) -> None:
    """Spot-check the SRS the main path generated against host scalar
    multiplication."""
    from paillier_halo2_tpu_torch.ec import host as ech
    from paillier_halo2_tpu_torch.ff.host import FR_MOD
    from paillier_halo2_tpu_torch.plonk import srs as srs_mod

    srs = srs_mod.read_or_create_srs(MAIN_K, device=dev, params_dir=params_dir)
    tau = srs_mod._dev_tau(b"")
    idx = [0, 1, 2, 1000, srs.n - 1]
    pts = srs.g1_points()
    for i in idx:
        require(pts[i] == ech.g1_mul(ech.G1, pow(tau, i, FR_MOD)), f"SRS point {i} is wrong")
    require(srs.g2_tau == ech.g2_mul(ech.G2, tau), "SRS [tau]G2 is wrong")
    log(f"  SRS k={MAIN_K}: G1 powers {idx} and [tau]G2 equal host scalar multiplication")


def _clone(x):
    import torch

    return x.clone() if isinstance(x, torch.Tensor) else tuple(_clone(y) for y in x)


class CaptureCall:
    """While active, records a copy of the arguments of call `index` of
    `module.name` (0 = the first); the call itself runs unchanged."""

    def __init__(self, module, name: str, index: int):
        self.module, self.name, self.index, self.seen, self.args = module, name, index, 0, None

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            if self.seen == self.index:
                self.args = _clone(args)
            self.seen += 1
            return fn(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_captured(name: str, kern, plain, args, flat_args) -> None:
    """One launch of the main path's inputs, kernel against plain version."""
    import torch

    out, ref = kern(*args), plain(*flat_args)
    torch.cuda.synchronize()
    require(all(torch.equal(o, r) for o, r in zip(out, ref)),
            f"{name} differs from its plain version at the MSM's lane count")
    log(f"    {name} on {out[0].shape[1]} lanes of this MSM: equal to its plain version "
        f"(max_abs_err {max_abs_err(out, ref)})")


def run_msm_entry(dev, k: int = 20) -> None:
    """bench.py's headline entry: MSM at 2^k points on both routes."""
    import torch

    from paillier_halo2_tpu_torch.ec import lazy_point as lp
    from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    n = 1 << k
    t0 = time.monotonic()
    srs = generate_srs(k, b"", dev)
    torch.cuda.synchronize()
    log(f"  SRS k={k} generated on the card in {time.monotonic() - t0:.3f} s")
    sd = bench_scalars(k, dev)
    want = msm_fixture(k)
    for signed, window_bits in ((True, None), (False, 8)):
        route = "signed" if signed else "unsigned"
        args = (srs.g1_px, srs.g1_py, srs.g1_inf, sd, window_bits, signed)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        # the second K5 launch adds to accumulators that are mostly finite
        with CaptureCall(lp, "padd_mixed_packed_lazy", 1) as k5, CaptureCall(lp, "padd_lazy", 0) as k6:
            first = msm_packed(*args)
        torch.cuda.synchronize()
        t_first = time.monotonic() - t0
        zero_counts()
        stats: dict = {}
        t0 = time.monotonic()
        warm = msm_packed(*args, stats=stats)
        torch.cuda.synchronize()
        t_warm = time.monotonic() - t0
        counts = read_counts()
        require(first == want and warm == want,
                f"2^{k} MSM ({route}) differs from params_fixtures/bench_msm_expected_{k}.json")
        shown = {name: counts[name] for name in
                 ("padd_mixed_packed_lazy", "padd_lazy", "g1_madd_packed", "g1_jadd")}
        log(f"  MSM 2^{k} {route} (window {window_bits or 'signed default'}): equals the fixture; first "
            f"{t_first:.4f} s, warm {t_warm:.4f} s = {n / t_warm:.1f} points/s; "
            f"{stats['lanes']} bucket lanes, {stats['rounds']} rounds, {stats['lane_rounds']} "
            f"lane-rounds; warm-call launches {shown}")
        log(f"    profile of a third call: {profile_call(lambda: msm_packed(*args), t_warm)}")
        if signed:
            require(k5.args is not None and k6.args is not None, "the signed route ran no K5 or K6")
            check_captured("padd_mixed_packed_lazy", lp.padd_mixed_packed_lazy,
                           lp.padd_mixed_packed_lazy_plain, k5.args, k5.args)
            check_captured("padd_lazy", lp.padd_lazy, lp.padd_lazy_plain, k6.args, (*k6.args[0], *k6.args[1]))


def run_mulmod_lazy(dev, log_n: int = 20) -> dict:
    """bench.py's `mulmod_lazy` phase on the card: ten chained K7 products
    over Fr at 2^20 lanes, against the same chain through K1. Returns the
    launches of the K7 chain."""
    import numpy as np
    import torch

    from paillier_halo2_tpu_torch.ff import field as f
    from paillier_halo2_tpu_torch.ff import lazy_mont as lz
    from paillier_halo2_tpu_torch.ff import mulmod

    n, reps, spec = 1 << log_n, 10, f.FR
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 32, size=(2, n, 8), dtype=np.uint64)
    a, b = (f.pack_ints([int.from_bytes(np.asarray(w, np.uint32).tobytes(), "little")
                         % (2 * spec.p) for w in half], dev) for half in words)
    r = lz.mont_mul_lazy(spec, a, b)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    for _ in range(reps):
        r = lz.mont_mul_lazy(spec, r, b)
    counts = read_counts()
    dt = time.monotonic() - t0
    rk = mulmod.mont_mul(spec, a, b)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        rk = mulmod.mont_mul(spec, rk, b)
    torch.cuda.synchronize()
    dt_k1 = time.monotonic() - t0
    require(torch.equal(lz.canonicalize(spec, r), rk),
            "the K7 chain, canonicalised, differs from the K1 chain")
    per_s = n * reps / dt
    log(f"  lazy mulmod Fr 2^{log_n} lanes x {reps}: {per_s / 1e6:.2f} M products/s, "
        f"{per_s * 96 / 1e9:.1f} GB/s effective (96 B per product); canonicalised equal to "
        f"the K1 chain ({n * reps / dt_k1 / 1e6:.2f} M products/s)")
    return counts


def bound(name: str, entry: dict, imad_per_s: float):
    """(bound_ms, bound_by) of one timed call of `name` (see WORK)."""
    products, dbl_products, nbytes = WORK[name]
    ops = IMAD_PER_PRODUCT * (products * entry["lanes"] + dbl_products * entry["double_lanes"])
    t_ops, t_bytes = ops / imad_per_s, nbytes * entry["lanes"] / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7", help="comma-separated phases to run")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's card path cannot run here")
    sys.path.insert(0, ROOT)
    from paillier_halo2_tpu_torch.utils import kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    imad_per_s = IMAD_PER_SM_CLOCK * n_sm * max_sm_mhz * 1e6
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {n_sm} SMs, max SM "
        f"clock {max_sm_mhz:.0f} MHz: {imad_per_s:.4g} 32-bit multiply-adds/s")
    t0 = time.monotonic()
    so = kernels.build()
    kernels.lib()
    log(f"[1] kernels built in {time.monotonic() - t0:.2f} s "
        f"(nvcc {kernels.BUILD_SECONDS if kernels.BUILD_SECONDS is not None else 'cached'}) "
        f"-> {os.path.relpath(so, ROOT)}")

    results: dict = {}
    launches: dict = {}
    if 2 in phases:
        log("[2] kernels against their plain versions on the card")
        check_mont_mul(dev, results)
        check_points(dev, results)
        check_mont_mul_lazy(dev, results)
        check_lazy_points(dev, results)
    if 3 in phases:
        log("[3] MSM 2^14, signed and unsigned routes")
        launches["g1_madd_packed"] = check_msm(dev)["g1_madd_packed"]
    if 4 in phases:
        log("[4] K=10 slice against the JAX fixture")
        check_slice_fixture(dev)
    if 5 in phases:
        log(f"[5] main path: ENC={MAIN_ENC}/LIMB={MAIN_LIMB}, k={MAIN_K}, "
            f"lookup_bits={MAIN_LOOKUP_BITS}")
        params_dir = os.path.join(ROOT, "build", "chip_smoke_params")
        shutil.rmtree(params_dir, ignore_errors=True)  # the SRS is generated in this run
        torch.cuda.synchronize()
        zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        stats = run_main_path(dev, params_dir)
        main_counts = read_counts()
        for line in stats.pretty().splitlines():
            log("  " + line)
        log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        log(f"  launches during the main path: {main_counts}")
        require(stats.verified, "main-path proof did not verify")
        for name in ("mont_mul", "g1_jadd", "g1_madd", "padd_mixed_packed_lazy", "padd_lazy"):
            launches[name] = main_counts[name]
        check_srs_cache(dev, params_dir)
    if 6 in phases:
        log("[6] MSM 2^20 entry, signed and unsigned routes")
        run_msm_entry(dev)
    if 7 in phases:
        log("[7] lazy-mulmod entry, Fr, 2^20 lanes")
        launches["mont_mul_lazy"] = run_mulmod_lazy(dev)["mont_mul_lazy"]
    if {3, 5, 7} <= phases:
        for name in KERNELS:
            require(launches[name] > 0, f"kernel {name} was not launched on its path")

    if results:
        kernels_line = []
        for name, (source, replaces) in KERNELS.items():
            r = results[name]
            bound_ms, bound_by = bound(name, r, imad_per_s)
            kernels_line.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches.get(name), "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, "device_ms": r["device_ms"],
            })
        print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
