#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases 1,2    # build the kernels and check them only

Phases:

1. print the card's name and power limit, then build the CUDA kernels from
   `paillier_halo2_tpu_torch/csrc/` (nvcc, sm_90a) and print the build time;
2. hold every kernel against its plain PyTorch version on the card, exactly,
   at the main path's shapes (2^16 lanes for mont_mul, 2^14 for the point
   adds) with edge lanes, and time both;
3. a 2^14-point MSM on the seed-b"" SRS equals
   `params_fixtures/bench_msm_expected_14.json`;
4. the K=10 encryption proof is byte-identical to the JAX package's fixture
   `tests/torch_fixtures/slice_enc_k10.json`, and the verifier accepts it and
   rejects a tampered copy;
5. the main path: `base_test().bench_builder` on the ENC=128/LIMB=64
   encryption circuit at k=14, lookup_bits=13 — SRS generated on the card
   into a fresh directory, keygen, witness, proof, verify — with every
   kernel's launch count taken over this run alone.

It needs a CUDA device and fails at once without one. Every failure raises.
Before the last line it prints one JSON object with each kernel's launch
count, error and times; the last line is
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
            entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms)
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
                entry.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms)
        results[name] = entry


# -- phases 3-5 ---------------------------------------------------------------------


def check_msm(dev) -> None:
    import numpy as np
    import torch

    from paillier_halo2_tpu_torch.ec import host as ech
    from paillier_halo2_tpu_torch.ff import field as f
    from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    k = 14
    srs = generate_srs(k, b"", dev)
    rng = np.random.default_rng(1)  # the scalar stream of bench.py's MSM phase
    hi = rng.integers(0, 2**63, (4, 1 << k), dtype=np.int64)
    scalars = [(int(x) | int(y) << 63 | int(z) << 126 | int(w) << 189) % ech.R
               for x, y, z, w in zip(*hi)]
    sd = f.pack_ints(scalars, dev)
    msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    with open(os.path.join(ROOT, "params_fixtures", f"bench_msm_expected_{k}.json")) as fh:
        ex, ey = json.load(fh)
    require(got == (int(ex, 16), int(ey, 16)), "2^14 MSM differs from its fixture")
    log(f"  MSM 2^14 equals params_fixtures/bench_msm_expected_14.json; warm {dt:.4f} s")


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


def run_main_path(dev, params_dir: str):
    from paillier_halo2_tpu_torch.bignum.host import paillier_enc_native
    from paillier_halo2_tpu_torch.harness.base_test import base_test
    from paillier_halo2_tpu_torch.harness.circuits import (
        PaillierEncryptionInput,
        paillier_enc_test,
    )

    prng = random.Random(14)  # bench.py's proof-phase inputs
    n = prng.getrandbits(MAIN_ENC) | (1 << (MAIN_ENC - 1)) | 1
    g, m, r = (prng.getrandbits(MAIN_ENC) for _ in range(3))
    inp = PaillierEncryptionInput(enc_bits=MAIN_ENC, limb_bits=MAIN_LIMB, n=n, g=g, m=m, r=r,
                                  res=paillier_enc_native(n, g, m, r))
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5", help="comma-separated phases to run")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's card path cannot run here")
    sys.path.insert(0, ROOT)
    from paillier_halo2_tpu_torch.ec import point_kernels
    from paillier_halo2_tpu_torch.ff import mulmod
    from paillier_halo2_tpu_torch.utils import kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.monotonic()
    so = kernels.build()
    kernels.lib()
    log(f"[1] kernels built in {time.monotonic() - t0:.2f} s "
        f"(nvcc {kernels.BUILD_SECONDS if kernels.BUILD_SECONDS is not None else 'cached'}) "
        f"-> {os.path.relpath(so, ROOT)}")

    results: dict = {}
    if 2 in phases:
        log("[2] kernels against their plain versions on the card")
        check_mont_mul(dev, results)
        check_points(dev, results)
    if 3 in phases:
        log("[3] MSM 2^14")
        check_msm(dev)
    if 4 in phases:
        log("[4] K=10 slice against the JAX fixture")
        check_slice_fixture(dev)
    launches = None
    if 5 in phases:
        log(f"[5] main path: ENC={MAIN_ENC}/LIMB={MAIN_LIMB}, k={MAIN_K}, "
            f"lookup_bits={MAIN_LOOKUP_BITS}")
        params_dir = os.path.join(ROOT, "build", "chip_smoke_params")
        shutil.rmtree(params_dir, ignore_errors=True)  # the SRS is generated in this run
        torch.cuda.synchronize()
        for counts in (mulmod.LAUNCHES, point_kernels.LAUNCHES):
            for key in counts:
                counts[key] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        stats = run_main_path(dev, params_dir)
        torch.cuda.synchronize()
        launches = {**mulmod.LAUNCHES, **point_kernels.LAUNCHES}
        for line in stats.pretty().splitlines():
            log("  " + line)
        log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        log(f"  launches during the main path: {launches}")
        require(stats.verified, "main-path proof did not verify")
        for name, count in launches.items():
            require(count > 0, f"kernel {name} was not launched on the main path")
        check_srs_cache(dev, params_dir)

    if results:
        kernels_line = []
        for name, (source, replaces) in KERNELS.items():
            r = results[name]
            kernels_line.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None if launches is None else launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "device_ms": r["device_ms"],
            })
        print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
