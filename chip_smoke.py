#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

    python3 chip_smoke.py                 # phases 1-8 and 10-13, as a release check
    python3 chip_smoke.py --phases 1,2    # build the kernels and check them only
    python3 chip_smoke.py --phases 1,10   # proving keys saved and loaded, GWC, instances
    python3 chip_smoke.py --phases 1,11   # the mesh layer and the distributed prover
    python3 chip_smoke.py --phases 1,12   # the bench entry points, k=17 proofs among them
    python3 chip_smoke.py --phases 1,13   # self-checked proofs, profile_chip
    python3 chip_smoke.py --phases 1,9    # the 2048-bit MockProver (opt-in)

Phases:

1. print the card's name and power limit, then build the CUDA kernels from
   `paillier_halo2_tpu_torch/csrc/` (one nvcc per source, all at once, sm_90a)
   and print the build time, each kernel's registers and spills (ptxas), and
   for the Fq product (`probes/fq_product.cu`) the SASS instructions of one
   product (`cuobjdump --dump-sass`) and its rate in a loop of chained
   products, checked against the host;
2. hold every kernel against its plain PyTorch version on the card, exactly,
   at the main path's shapes (2^16 lanes for the Montgomery products and the
   field adds and subs, 2^14 for the point adds) with edge lanes, and time
   both; the redundant-form kernels K5-K7, canonicalised, also equal K4, K2
   and K1 on the same inputs;
3. a 2^14-point MSM on the seed-b"" SRS equals
   `params_fixtures/bench_msm_expected_14.json` on both routes: signed
   windows (the bucket-loop, merge and window-sum kernels, one launch of
   each and no K5, K6 or K2 step) and unsigned windows (its bucket-loop
   kernel, one launch and no K4 step, and K2's merge, whose launches are
   counted here); the four loop kernels are held against their plain
   versions on that MSM's lane tables, accumulators and buckets, and the
   comb kernel on that SRS's scalars, and timed;
4. the K=10 encryption proof, its commitments on the signed route, is
   byte-identical to the JAX package's fixture
   `tests/torch_fixtures/slice_enc_k10.json`, and the verifier accepts it and
   rejects a tampered copy;
5. the main path: `base_test().bench_builder` on the ENC=128/LIMB=64
   encryption circuit at k=14, lookup_bits=13 — SRS generated on the card
   into a fresh directory, keygen, witness, proof, verify — with every
   kernel's launch count taken over this run alone (one comb launch, one
   launch of each loop kernel per MSM call, no K3, K5, K6 or K2 step, no
   operand of the field add/sub kernel copied); the comb kernel is held
   against its plain version on the SRS's scalars and the three loop
   kernels on the first MSM call's inputs (its lane table, accumulators and
   buckets), timed there, and the kernels line takes their entries from
   this comparison;
6. the MSM 2^20 entry (bench.py's headline phase): the seed-b"" SRS generated
   at k = 20 on the card, bench.py's scalars, the signed route (c = 11) and
   the unsigned route (window 8), each equal to
   `params_fixtures/bench_msm_expected_20.json`, with first and warm times;
   the SRS's comb is held against the 32 K3 launches it replaces, the
   signed route's window sums against their plain version, its bucket loop
   against the rounds composed of K5 step launches on the same lane table
   (one of those K5 launches against its plain version) and its merge
   against the levels composed of K6 launches, the unsigned route's bucket
   loop against the rounds of K4 step launches (one of those against its
   plain version), and these kernels are timed, with the unsigned loop's
   serial floor (one block of the longest lanes alone);
7. the lazy-mulmod entry (bench.py's `mulmod_lazy` phase): ten chained K7
   products over Fr at 2^20 lanes, equal after canonicalisation to the same
   chain through K1; K7's launches are counted here;
8. the MockProver (`base_test().run`, the reference's test path), K1 for
   its gate products: the reference's two test geometries (encryption at
   ENC=128/LIMB=64 and addition at ENC=264/LIMB=88, k=16, lookup_bits=15,
   `tests/test_gadgets.py`'s inputs) satisfied and equal to the host
   oracle; the 512-bit encryption of `tests/test_big_geometry.py` (about
   10.8 M rows) satisfied one-shot and streamed in 2^21-row chunks; a
   tampered copy (16 values set to v + 1 mod p, among them a gate, a
   lookup, a copy and a constant row, a chunk's first row and the three
   overlap rows after a chunk's end) with equal failure arrays one-shot,
   chunked and on the host oracle; K1 held against its plain version on
   that check's own b*c operands. Each run prints its counts, route, pack
   seconds, device-check milliseconds (CUDA events), K1 launches, peak
   device memory and the check's memory bound. K1's launches over this
   phase are counted apart from the main path's.
10. proving keys, GWC and instance columns: (a) phase 4's K=10 proof under
   GWC multi-open, byte-identical to `tests/torch_fixtures/slice_enc_k10_gwc.json`,
   verified, a tampered copy rejected; (b) the K=10 statement of
   `tests/test_instance.py` (n, g and the ciphertext public), byte-identical
   to `instance_enc_k10.json`, verified with its public values, rejected
   with a ciphertext limb changed, refused without them; (c) the addition
   circuit at `bench_add.py`'s geometry (ENC=128/LIMB=64, k=14,
   lookup_bits=13, its `random.Random(141)` inputs) as `bench_add.py` runs
   it: SRS from phase 5's directory (generated here when phase 5 does not
   run), synthesis, `table_fingerprint`, keygen, `save_proving_key` under
   `build/chip_smoke_keys/`, `load_proving_key` under the fingerprint, a
   proof from the loaded key, byte-identical to one from the fresh key with
   the same blinding seed and verified against the original verifying key;
   a load under another fingerprint raises; (d) phase 5's circuit and inputs
   at k=14 under GWC: keygen, proof, verify, a tampered copy rejected, the
   key saved and loaded back as GWC. Each step's seconds, the key file's and
   the proofs' bytes and peak device memory are printed. Over (c) and (d)
   each loop kernel launches once per bucket pass of an MSM call, no K3,
   K5, K6 or K2 step runs, and the comb only if the SRS was generated here;
   these launches are counted apart from phase 5's. The loop kernels are
   held against their plain versions on (c)'s first MSM call (and the comb
   on its SRS where it ran), K1 on the widest operands of (c) and (d).
11. the mesh layer and the distributed prover on `make_mesh(4, "cuda:0")`
   (one shard a card where the machine has two or more cards; the phase
   prints how many cards the mesh spans): (a) the four-step NTT at k=14 and
   at the main path's extended k, forward and inverse, bit-equal to
   `poly/ntt.ntt`; (b) the sharded MSM at 2^14 and 2^20 on the seed-b"" SRS
   with bench.py's scalars, equal to both fixtures, with one bucket loop and
   one merge a shard, one K2 launch a tree level and one window-sum launch
   a call, its warm seconds, points/s and device time printed beside the
   unsharded signed route's, and K2 held against its plain version on the
   2^20 call's first tree level; (c) phase 4's K=10 proof through
   `keygen_sharded` and `create_proof_sharded`, byte-identical to the JAX
   fixture and verified; (d) phase 5's circuit (k=14 ENC=128/LIMB=64)
   through `keygen_sharded` and `create_proof_sharded` with a fixed
   blinding seed: the verifying key's commitments equal single-device
   keygen's, the proof bytes equal the single-device proof's, it verifies,
   and the seconds of both and the peak device memory are printed; the
   launches over the sharded keygen and proof must be one bucket loop and
   one merge a shard, one window-sum launch and one K2 launch a tree level
   per bucket pass, and no K3, K5 or K6 step; the loop kernels are held
   against their plain versions on the first sharded call's first shard,
   K2 on its first tree level, K1 on the widest operands; (e)
   `entry.dryrun_multichip(8, device="cuda:0")` runs to its end.
12. the bench entry points (`paillier_halo2_tpu_torch/benches/`) as a user
   calls them: (a) `bench_batch` at B=16, k=17, lookup_bits=16, ENC=128
   (BASELINE.json config 4), its SRS made on the card: 6,890,664 rows, 53
   advice columns and a 19,808-byte proof (`params_fixtures/batch16_k17.json`),
   verified, a tampered copy rejected, synthesized by more than one pool
   worker; over its SRS, keygen and proofs one comb launch, each loop kernel
   once per bucket pass and no K3, K5, K6 or K2 step; the loop kernels held
   against their plain versions on its first MSM call, the comb against K3's
   steps on its SRS and K1 against its plain version on its widest operands;
   (b) `bench_bigenc` at 512 bits, k=17: 9,271,869 rows, 71 advice columns,
   24,992 bytes (`bigenc512_k17.json`), verified, a tampered copy rejected,
   its launches as (a)'s without a comb; (c) `benches.bench` in a process
   of its own: a line after every phase, the last with `msm_valid` and a
   verified proof; (d) `bench_scaling` at 2^20 on up to 8 shards of one card
   and a 2 x 4 mesh, every point equal to the unsharded MSM, one bucket loop
   a shard, one K2 launch a tree level and one window-sum launch a call;
   (e) `bench_add` at k=14 twice: 2,002 rows, 1 advice column, 1,152 bytes
   (`bench_add_k14.json`), verified, the second run on the key the first
   saved; (f) `profile_proof` at k=14 with 2 warm proofs, their marks and
   transfers, and the last one's profiler trace. Synthesis, keygen, proof
   and verify seconds and peak device memory are printed for (a) and (b),
   and the device time by kernel of a third B=16 proof under torch.profiler.
13. the prover's self-checks and the MSM profile: (a) one k=14 ENC=128 key
   (phase 5's circuit and SRS, the SRS generated here when phase 5 does not
   run) and one blinding seed give proofs with `checks="all"`,
   `"closing"` and `"none"`, the levels in turns over two rounds:
   byte-identical and verified, each one's seconds printed (what the
   checks cost on the card); (b) phase 10's add
   circuit at k=14 under GWC, proved with `checks="all"` and `"closing"`:
   equal, and `verify_proof(selfcheck=True)` accepts it opening by
   opening. Over (a) and (b) each loop kernel launches once per bucket
   pass, no K3, K5, K6 or K2 step runs, the loop kernels are held against
   their plain versions on (a)'s first MSM call, K1 and the field add/sub
   kernel on their widest operands (the add's as the prover laid them out,
   broadcast or strided), and each proof's SHA-256 is printed, so that two
   checkouts' proofs can be compared; (c) `benches.profile_chip` (all four
   phases: the copy rate, K1 and K7 at 2^20 lanes, K4's and K2's adds at
   2^16, the signed MSM at 2^20 whole and by part, its point equal to the
   fixture) on phase 12's k=20 SRS (generated here when phase 12 does not
   run). No NTT of phase 5
   or 13 takes the native route (`poly.ops.NTT_ROUTES`): a transform on
   the card never goes to the host.

Not in the default set:

9. BASELINE.json config 1: the 2048-bit encryption MockProver (about 319 M
   rows), one-shot where the device's free memory holds it, else chunked;
   it first checks the host's MemAvailable, and prints synthesis, pack and
   check times, the route, peak host RSS and peak device memory; then it
   checks the table once more under torch.profiler and prints the device
   time by kernel.

It needs a CUDA device and fails at once without one. Every failure raises.
Before the last line it prints one JSON object with each kernel's launch
count (over the path that runs it), error, times and bound; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Build outputs, the SRS caches, phases 10's and 12's keys and phase 12's
traces go under `build/` in this checkout. Phase 11's shards on one card measure the cost of sharding, not
scale-out.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
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
    "bucket_loop": ("paillier_halo2_tpu_torch/csrc/g1_add.cu",
                    "paillier_halo2_tpu/ec/pallas_point.py:309"),
    "padd_mixed_packed_lazy": ("paillier_halo2_tpu_torch/csrc/g1_add_lazy.cu",
                               "paillier_halo2_tpu/ec/lazy_point.py:172"),
    "padd_lazy": ("paillier_halo2_tpu_torch/csrc/g1_add_lazy.cu",
                  "paillier_halo2_tpu/ec/lazy_point.py:220"),
    "mont_mul_lazy": ("paillier_halo2_tpu_torch/csrc/mont_mul_lazy.cu",
                      "paillier_halo2_tpu/ff/lazy_mont.py:301"),
    "window_sums": ("paillier_halo2_tpu_torch/csrc/g1_add.cu",
                    "paillier_halo2_tpu/ec/pallas_point.py:230"),
    "bucket_loop_lazy": ("paillier_halo2_tpu_torch/csrc/g1_add_lazy.cu",
                         "paillier_halo2_tpu/ec/lazy_point.py:172"),
    "merge_lazy": ("paillier_halo2_tpu_torch/csrc/g1_add_lazy.cu",
                   "paillier_halo2_tpu/ec/lazy_point.py:220"),
    "fixed_base_comb": ("paillier_halo2_tpu_torch/csrc/g1_add.cu",
                        "paillier_halo2_tpu/ec/pallas_point.py:265"),
    "field_addsub": ("paillier_halo2_tpu_torch/csrc/field_addsub.cu",
                     "none: the Python carry loops of ff/field.py (XLA's in the JAX package)"),
}
# Where each kernel's launches are counted: the main path (phase 5) unless
# named here. K3's, K4's, K5's and K6's one-step kernels are the JAX
# package's counterparts and the references the comb, bucket-loop and merge
# kernels are composed against; since those kernels they run on no path.
LAUNCH_PATH = {"g1_jadd": "phase 3, unsigned 2^14 MSM (sub-accumulator merge)",
               "bucket_loop": "phase 3, unsigned 2^14 MSM",
               "g1_madd_packed": "none (step kernel, held in phase 2)",
               "mont_mul_lazy": "phase 7, lazy-mulmod chain",
               "padd_mixed_packed_lazy": "none: off every path since the bucket-loop kernel",
               "g1_madd": "none: off every path since the comb kernel",
               "padd_lazy": "none: off every path since the merge kernel"}
OFF_PATH = [name for name, where in LAUNCH_PATH.items() if where.startswith("none")]
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
# The loop kernels' work depends on the call: `loop_work` counts it from the
# inputs (products per add as in WORK, doubling products not counted: an MSM
# bucket pair is P == Q, finite, with probability about 2^-254).
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
    "field_addsub": (0, 0, 3 * 32),
}
MAIN_K, MAIN_LOOKUP_BITS, MAIN_ENC, MAIN_LIMB = 14, 13, 128, 64
# Phase 8: the reference's MockProver geometries (tests/test_gadgets.py's
# RNG seed) and the 512-bit stream (tests/test_big_geometry.py's seed).
MOCK_SEED, MOCK_K, MOCK_LOOKUP_BITS = 20260817, 16, 15
BIG_SEED, BIG_ENC, BIG_LIMB, BIG_CHUNK_ROWS = 2048, 512, 64, 1 << 21
# Phase 9: host bytes the 2048-bit run needs: its table's 319 M Python ints
# and index arrays with synthesis's transients peaked at 21.9 to 24.9 GiB
# of RSS on the H100 machine (PERF.md), and this leaves a margin.
CONFIG1_ENC, CONFIG1_HOST_BYTES = 2048, 32 << 30
# Phase 10: bench_add.py's widths and inputs (random.Random(141)); its k and
# lookup_bits are the main path's.
ADD_ENC, ADD_LIMB, ADD_SEED = 128, 64, 141
PHASE10_BLIND = b"chip-smoke phase 10"
# Phase 11: shards of the mesh on one card (one shard a card where there are
# two or more cards), and of the dry run.
MESH_SHARDS, DRYRUN_SHARDS = 4, 8
MESH_MSM_KS = (14, 20)  # the sharded MSM's sizes: the fixtures' (bench.py's 2^20)
PHASE11_BLIND = b"chip-smoke phase 11"
# Phase 12: the bench entries at the reference runs' widths: `bench_batch.py
# 16 17 16 128` (BASELINE.json config 4; 53 advice columns, HEAVY_RUNS.md,
# where its fixture has no count) and `bench_bigenc.py 512 17`; `bench.py`
# with its phases' lines; the scaling sweep at bench.py's MSM size over up
# to 8 shards of one card; `profile_proof.py 14 2`.
BATCH_B, BATCH_K, BATCH_ENC, BATCH_ADVICE_COLS = 16, 17, 128, 53
BIGENC_ENC, BIGENC_K = 512, 17
BENCH_BUDGET_S = 600
BENCH_PHASES = ["start", "mulmod", "mulmod_lazy", "msm", "keygen", "proof_cold", "final"]
SCALING_LOG2, SCALING_SHARDS = 20, 8
PROFILE_REPS = 2
# Phase 13: the check levels, proved with one key and one seed.
PHASE13_BLIND, PHASE13_ROUNDS = b"chip-smoke phase 13", 2
PROFILE_MSM_LOG2 = 20  # profile_chip's MSM: bench.py's size, phase 12's SRS


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
    "K4 g1_madd_packed": "g1_madd_kernel<true, true>", "K4 bucket loop": "g1_bucket_kernel",
    "K5 padd_mixed_packed_lazy": "g1_madd_lazy_kernel",
    "K6 padd_lazy": "g1_jadd_lazy_kernel", "K7 mont_mul_lazy": "mont_mul_lazy_kernel",
    "K2 window sums": "g1_window_sums_kernel", "K5 bucket loop": "g1_bucket_lazy_kernel",
    "K6 merge": "g1_merge_lazy_kernel", "K3 comb": "g1_fixed_base_comb_kernel",
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


# -- phase 1: what the compiler made ------------------------------------------------


def ptxas_report(log_path: str) -> None:
    """Each kernel's registers and spill bytes from the build's ptxas -v log."""
    import re

    with open(log_path) as fh:
        text = fh.read()
    rows = []
    for b in re.split(r"Compiling entry function ", text)[1:]:
        name = b.split("'")[1]
        short = re.search(r"\d+((?:g1|mont)_\w*?_kernel)(I\w+?EE)?", name)
        regs = re.search(r"Used (\d+) registers", b)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", b)
        rows.append(f"{''.join(g or '' for g in short.groups()) if short else name}: "
                    f"{regs.group(1) if regs else '?'} registers, spill stores/loads "
                    f"{spill.group(1) + '/' + spill.group(2) if spill else '?'} B")
    log("  ptxas (sm_90a): " + "; ".join(rows))


def product_probe() -> None:
    """Build probes/fq_product.cu, count the SASS instructions of one Fq
    product, redundant and canonical (all, IMAD*, IADD3*; the kernel's loads
    and stores of its 24 words included), and run its timed loop; the probe
    exits non-zero if its bits differ from the host's."""
    import re

    from paillier_halo2_tpu_torch.utils import kernels

    nvcc = kernels._nvcc()
    exe = os.path.join(kernels.BUILD_DIR, "fq_product_probe")
    subprocess.run([nvcc, *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-I", kernels.CSRC, "-o", exe,
                    os.path.join(ROOT, "paillier_halo2_tpu_torch", "probes", "fq_product.cu")],
                   check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "--dump-sass", exe], capture_output=True, text=True,
                              check=True).stdout
        counts = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            name = part.split()[0]
            if not name.startswith("probe_"):
                continue
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", part)
            ops = [o for o in ops if o != "NOP"]
            counts[name[len("probe_"):]] = (len(ops), sum(o.startswith("IMAD") for o in ops),
                                            sum(o.startswith("IADD3") for o in ops))
        log("  SASS per Fq product (instructions, IMAD*, IADD3*): " + "; ".join(
            f"{k} {v}" for k, v in sorted(counts.items())))
    else:
        log("  SASS per Fq product: not measured (no cuobjdump beside nvcc)")
    run = subprocess.run([exe], capture_output=True, text=True)
    for line in run.stdout.splitlines():
        log("  " + line)
    require(run.returncode == 0, f"the Fq product probe failed: {run.stderr[-2000:]}")


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


def check_field_addsub(dev, results: dict) -> None:
    """The field add/sub kernel against `add_plain` / `sub_plain` at 2^16
    lanes, both fields and both operations, edge lanes first; timed on Fr's
    add."""
    import numpy as np
    import torch

    from paillier_halo2_tpu_torch.ff import field as f

    n = 1 << 16
    rng = np.random.default_rng(3)
    entry = {"max_abs_err": 0}
    for spec in (f.FR, f.FQ):
        edge = [0, 1, spec.p - 1, spec.p - 2, spec.r_mod_p]
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        xs = [int.from_bytes(np.asarray(w, np.uint32).tobytes(), "little") % spec.p for w in words]
        ys = xs[1:] + xs[:1]
        for i, (u, v) in enumerate((u, v) for u in edge for v in edge + [spec.p - u]):
            xs[i], ys[i] = u, v % spec.p
        a, b = f.pack_ints(xs, dev), f.pack_ints(ys, dev)
        for op, sign in (("add", 1), ("sub", -1)):
            before = f.LAUNCHES[op]
            out = getattr(f, op)(spec, a, b)
            ref = getattr(f, op + "_plain")(spec, a, b)
            torch.cuda.synchronize()
            require(f.LAUNCHES[op] == before + 1, f"{op}({spec.name}) did not launch once")
            require(torch.equal(out, ref), f"{op}({spec.name}) differs from its plain version")
            require(f.unpack_ints(out[:, :64]) == [(x + sign * y) % spec.p
                                                   for x, y in zip(xs[:64], ys[:64])],
                    f"{op}({spec.name}) differs from Python ints")
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs_err([out], [ref]))
        if spec is f.FR:
            entry.update(addsub_timing(lambda: f.add(spec, a, b), lambda: f.add_plain(spec, a, b),
                                       n))
            log(f"  field add Fr 2^16 lanes: equal, kernel {entry['ms']} ms per call "
                f"({entry['device_ms']} ms on the device), plain {entry['plain_ms']} ms")
    require(f.LAUNCHES["copied"] == 0, "the field add/sub kernel copied a contiguous operand")
    results["field_addsub"] = entry


def addsub_timing(kernel_fn, plain_fn, lanes: int) -> dict:
    return {"lanes": lanes, "double_lanes": 0, "ms": cuda_ms(kernel_fn, 50),
            "plain_ms": cuda_ms(plain_fn, 5),
            "device_ms": device_ms(kernel_fn, 20, "field_addsub_kernel")}


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


# -- the loop kernels on an MSM's own inputs ----------------------------------------


def window_adds(n_buckets: int) -> int:
    """Point adds of one row of the window sums: every lane at each step of
    the scan, then only the lanes that reach lane 0 at each step of the
    reduction (`g1_window_sums_kernel`)."""
    log_b = (n_buckets - 1).bit_length()
    adds = n_buckets * log_b
    for i in range(log_b):
        stride = 2 << i
        lanes = {m * stride % n_buckets for m in range(1 << (log_b - i - 1))}
        adds += len(lanes)
    return adds


def loop_work(name: str, args) -> tuple[int, int]:
    """(multiply-adds, bytes) of one call of a loop kernel on `args`: each
    input read once, each output written once."""
    from paillier_halo2_tpu_torch.ec import point_kernels as pk

    if name == "window_sums":
        rows, n_buckets = args[0].shape[1:]
        return (IMAD_PER_PRODUCT * WORK["g1_jadd"][0] * rows * window_adds(n_buckets),
                96 * rows * (n_buckets + 1))
    if name == "merge_lazy":  # s - 1 tree adds a live bucket
        acc, blocks, n_buckets = args
        adds = sum(len(rows) * bc * (s - 1) for s, bc, rows in blocks)
        n_rows = sum(len(rows) for _, _, rows in blocks)
        return (IMAD_PER_PRODUCT * WORK["padd_lazy"][0] * adds,
                96 * acc[0].shape[1] + 96 * n_rows * n_buckets)
    if name == "fixed_base_comb":  # 32 windows a scalar; SRS scalars are below r,
        table, table_inf, scalars = args  # so no lane takes the doubling branch
        n = scalars.shape[1]
        return (IMAD_PER_PRODUCT * WORK["g1_madd"][0] * 32 * n,
                table.numel() * 4 + table_inf.numel() + 32 * n + 96 * n)
    packed, order, seg, count, sub, nsub = loop_table(name, args)
    lane_rounds = int(pk._need(count.long(), sub.long(), nsub.long()).sum())
    n_lanes = seg.shape[0]
    order_bytes = order.numel() * (4 if name == "bucket_loop" else 5)  # and neg's bytes
    nbytes = packed.numel() * 4 + order_bytes + n_lanes * (6 * 4 + 3 * 32)
    step = "g1_madd_packed" if name == "bucket_loop" else "padd_mixed_packed_lazy"
    return IMAD_PER_PRODUCT * WORK[step][0] * lane_rounds, nbytes


def loop_table(name: str, args):
    """(packed, order, seg, count, sub, nsub) of a bucket-loop call: the
    unsigned loop's arguments have no `neg`."""
    packed, order = args[:2]
    return (packed, order, *args[2:6]) if name == "bucket_loop" else (packed, order, *args[3:7])


def describe(name: str, args) -> str:
    if name == "window_sums":
        return f"{args[0].shape[1]} rows x {args[0].shape[2]} buckets"
    if name == "merge_lazy":
        acc, blocks, n_buckets = args
        adds = sum(len(rows) * bc * (s - 1) for s, bc, rows in blocks)
        blk = ", ".join(f"s={s} x {len(rows)} rows x {bc}" for s, bc, rows in blocks)
        return f"{acc[0].shape[1]} accumulators ({blk} buckets of {n_buckets}), {adds} tree adds"
    if name == "fixed_base_comb":
        return f"{args[2].shape[1]} scalars x 32 windows"
    from paillier_halo2_tpu_torch.ec import point_kernels as pk

    _, _, seg, count, sub, nsub = loop_table(name, args)
    need = pk._need(count.long(), sub.long(), nsub.long())
    return f"{seg.shape[0]} lanes, {int(need.sum())} lane-rounds, at most {int(need.max())}"


def _kernel_tables():
    """For each loop kernel: (wrapper, plain version, CUDA symbol, and its
    composition of step launches: (module, step name, composed function,
    step's plain version, the step's arguments as the plain version takes
    them), or None where it has none)."""
    from paillier_halo2_tpu_torch.ec import lazy_point as lp
    from paillier_halo2_tpu_torch.ec import point_kernels as pk

    return {
        "window_sums": (pk.window_sums, pk.window_sums_plain, "g1_window_sums_kernel", None),
        "bucket_loop": (
            pk.bucket_loop, pk.bucket_loop_plain, "g1_bucket_kernel",
            (pk, "g1_madd_packed", "K4", lambda *a: pk.k4_rounds(pk.g1_madd_packed, *a),
             pk.g1_madd_packed_plain, lambda a: a)),
        "bucket_loop_lazy": (
            lp.bucket_loop_lazy, lp.bucket_loop_lazy_plain, "g1_bucket_lazy_kernel",
            (lp, "padd_mixed_packed_lazy", "K5",
             lambda *a: lp.bucket_rounds(lp.padd_mixed_packed_lazy, *a),
             lp.padd_mixed_packed_lazy_plain, lambda a: a)),
        "merge_lazy": (
            lp.merge_lazy, lp.merge_lazy_plain, "g1_merge_lazy_kernel",
            (lp, "padd_lazy", "K6",
             lambda *a: lp.canonicalize_jp(*lp.merge_rounds(lp.padd_lazy, *a)),
             lp.padd_lazy_plain, lambda a: (*a[0], *a[1]))),
        "fixed_base_comb": (
            pk.fixed_base_comb, pk.fixed_base_comb_plain, "g1_fixed_base_comb_kernel",
            (pk, "g1_madd", "K3", lambda *a: pk.comb_rounds(pk.g1_madd, *a), pk.g1_madd_plain,
             lambda a: a)),
    }


def check_loop_kernels(captured: dict, where: str, imad_per_s: float,
                       reference: str = "plain") -> dict:
    """The loop kernels (window sums, bucket loop, merge, comb) on captured
    inputs, held against a reference and timed: with "plain" each against
    its plain version; with "steps" each that has one against its
    composition of step launches (the bucket loops against K4's or K5's
    rounds, the merge against K6's levels, the comb against 32 K3
    launches), one of those launches against the step's plain version, and
    the window sums against their plain version. Returns results entries."""
    import torch

    tables = _kernel_tables()
    entries = {}
    for name, args in captured.items():
        kern, plain, symbol, steps = tables[name]
        entry = {}
        stepwise = steps is not None and reference == "steps"
        t0 = time.monotonic()
        if stepwise:
            module, step_name, label, composed, step_plain, flat = steps
            with CaptureCall(module, step_name, 1) as step:
                ref = composed(*args)
        else:
            ref = plain(*args)
        torch.cuda.synchronize()
        ref_s = time.monotonic() - t0
        out = kern(*args)
        torch.cuda.synchronize()
        entry["max_abs_err"] = max_abs_err(out, ref)
        ref_name = f"the composed {label} step launches" if stepwise else "its plain version"
        require(all(torch.equal(o, r) for o, r in zip(out, ref)),
                f"{name} differs from {ref_name} ({where})")
        said = f"equal to {ref_name} (max_abs_err {entry['max_abs_err']}, {ref_s:.3f} s)"
        if stepwise:
            require(step.args is not None, f"the composed {label} steps ran no second step")
            check_captured(step_name, getattr(module, step_name), step_plain, step.args,
                           flat(step.args))
        else:
            entry["plain_ms"] = ref_s * 1e3
        entry["device_ms"] = device_ms(lambda: kern(*args), 5, symbol)
        entry["ms"] = cuda_ms(lambda: kern(*args), 5)
        entry["ops"], entry["bytes"] = loop_work(name, args)
        bound_ms, bound_by = bound(name, entry, imad_per_s)
        log(f"  {name} on {where} ({describe(name, args)}): {said}; kernel {entry['ms']} ms "
            f"per call ({entry['device_ms']} ms on the device); bound {bound_ms} ms ({bound_by})")
        entries[name] = entry
    return entries


class LoopCaptures:
    """While active, copies the arguments of the first call of each loop
    kernel's wrapper: the comb, the bucket loops, the merge, the window sums."""

    def __enter__(self):
        from paillier_halo2_tpu_torch.ec import lazy_point as lp
        from paillier_halo2_tpu_torch.ec import point_kernels as pk

        self.calls = {"fixed_base_comb": CaptureCall(pk, "fixed_base_comb", 0),
                      "bucket_loop_lazy": CaptureCall(lp, "bucket_loop_lazy", 0),
                      "bucket_loop": CaptureCall(pk, "bucket_loop", 0),
                      "merge_lazy": CaptureCall(lp, "merge_lazy", 0),
                      "window_sums": CaptureCall(pk, "window_sums", 0)}
        for c in self.calls.values():
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in self.calls.values():
            c.__exit__(*exc)

    def captured(self, *names) -> dict:
        for name in names:
            require(self.calls[name].args is not None, f"{name} was not called")
        return {name: self.calls[name].args for name in names}


# -- phases 3-5 ---------------------------------------------------------------------


def zero_counts() -> None:
    from paillier_halo2_tpu_torch.ec import lazy_point, point_kernels
    from paillier_halo2_tpu_torch.ff import field, lazy_mont, mulmod

    for counts in (mulmod.LAUNCHES, point_kernels.LAUNCHES, lazy_point.LAUNCHES,
                   lazy_mont.LAUNCHES, field.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    import torch

    from paillier_halo2_tpu_torch.ec import lazy_point, point_kernels
    from paillier_halo2_tpu_torch.ff import field, lazy_mont, mulmod

    torch.cuda.synchronize()
    return {**mulmod.LAUNCHES, **point_kernels.LAUNCHES, **lazy_point.LAUNCHES,
            **lazy_mont.LAUNCHES, **field.LAUNCHES,
            "field_addsub": field.LAUNCHES["add"] + field.LAUNCHES["sub"]}


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


def check_msm(dev, results: dict, imad_per_s: float) -> dict:
    """The 2^14 MSM on both routes, the loop kernels on the signed route's
    inputs, the unsigned bucket loop on the unsigned route's and the comb on
    its SRS's scalars; returns the launches of the unsigned route's run, the
    one that runs its bucket loop and K2's merge."""
    import torch

    from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    k = 14
    with LoopCaptures() as cap:
        srs = generate_srs(k, b"", dev)
        sd = bench_scalars(k, dev)
        msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd, signed=True)
        msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd, signed=False)
    torch.cuda.synchronize()
    captured = cap.captured("fixed_base_comb", "bucket_loop_lazy", "merge_lazy", "window_sums",
                            "bucket_loop")
    want = msm_fixture(k)
    counts = {}
    for signed in (True, False):
        zero_counts()
        t0 = time.monotonic()
        got = msm_packed(srs.g1_px, srs.g1_py, srs.g1_inf, sd, signed=signed)
        counts[signed] = read_counts()
        dt = time.monotonic() - t0
        route = "signed" if signed else "unsigned"
        require(got == want, f"2^14 MSM ({route}) differs from its fixture")
        log(f"  MSM 2^14 {route} equals params_fixtures/bench_msm_expected_14.json; warm {dt:.4f} s")
    log(f"  launches, signed: {counts[True]}; unsigned: {counts[False]}")
    require(all(counts[True][name] == 1 for name in ("bucket_loop_lazy", "merge_lazy", "window_sums")),
            "the signed route did not launch each loop kernel once")
    require(all(counts[True][name] == 0 for name in ("padd_mixed_packed_lazy", "padd_lazy", "g1_jadd")),
            "the signed route launched a K5, K6 or K2 step")
    require(counts[False]["bucket_loop"] == 1 and counts[False]["g1_jadd"] > 0
            and counts[False]["window_sums"] == 1,
            "the unsigned route did not launch its bucket loop once, K2's merge and the "
            "window sums")
    require(counts[False]["g1_madd_packed"] == 0, "the unsigned route launched a K4 step")
    results.update(check_loop_kernels(captured, "the 2^14 MSM's calls (the bucket loop: "
                                      "unsigned; the others: signed) and its SRS", imad_per_s))
    return counts[False]


def check_slice_fixture(dev, name: str = "slice_enc_k10.json",
                        multiopen: str = "shplonk") -> None:
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

    fx = torch_fixture(name)
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"],
                                  **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    table = ctx.finalize()
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), dev)
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs, multiopen=multiopen)
    proof = create_proof(pk, table, fx["blinding_seed"].encode())
    require(proof.hex() == fx["proof_hex"], f"K=10 {multiopen} proof differs from {name}")
    require(verify_proof(pk.vk, srs, proof), f"K=10 {multiopen} proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify_proof(pk.vk, srs, bytes(bad)), f"tampered K=10 {multiopen} proof verifies")
    log(f"  K=10 {multiopen} proof: {len(proof)} bytes, byte-identical to {name}, verified; "
        "tampered copy rejected")


def torch_fixture(name: str) -> dict:
    with open(os.path.join(ROOT, "tests", "torch_fixtures", name)) as fh:
        return json.load(fh)


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

    if isinstance(x, torch.Tensor):
        return x.clone()
    return tuple(_clone(y) for y in x) if isinstance(x, (tuple, list)) else x


class CaptureCall:
    """While active, records a copy of the arguments of call `index` of
    `module.name` (0 = the first); the call itself runs unchanged."""

    def __init__(self, module, name: str, index: int):
        self.module, self.name, self.index, self.seen, self.args = module, name, index, 0, None
        self.kwargs = {}

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            if self.seen == self.index:
                self.args, self.kwargs = _clone(args), dict(kwargs)
            self.seen += 1
            return fn(*args, **kwargs)

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


def run_msm_entry(dev, imad_per_s: float, k: int = 20) -> None:
    """bench.py's headline entry: MSM at 2^k points on both routes; the SRS's
    comb and both routes' loop kernels held against references on their real
    inputs; the unsigned bucket loop's serial floor timed."""
    import torch

    from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    n = 1 << k
    t0 = time.monotonic()
    with LoopCaptures() as srs_cap:
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
        with LoopCaptures() as cap:
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
                 ("bucket_loop_lazy", "merge_lazy", "padd_mixed_packed_lazy", "padd_lazy",
                  "bucket_loop", "g1_madd_packed", "g1_jadd", "window_sums")}
        log(f"  MSM 2^{k} {route} (window {window_bits or 'signed default'}): equals the fixture; first "
            f"{t_first:.4f} s, warm {t_warm:.4f} s = {n / t_warm:.1f} points/s; "
            f"{stats['lanes']} bucket lanes, {stats['rounds']} rounds, {stats['lane_rounds']} "
            f"lane-rounds; warm-call launches {shown}")
        log(f"    profile of a third call: {profile_call(lambda: msm_packed(*args), t_warm)}")
        require(counts["window_sums"] == 1, f"the {route} route did not sum its windows in one launch")
        if signed:
            require(counts["bucket_loop_lazy"] == 1 and counts["merge_lazy"] == 1,
                    "the signed route did not run its bucket loop and merge in one launch each")
            require(all(counts[name] == 0 for name in ("padd_mixed_packed_lazy", "padd_lazy", "g1_jadd")),
                    "the signed route ran a K5, K6 or K2 step")
            check_loop_kernels({**srs_cap.captured("fixed_base_comb"),
                                **cap.captured("window_sums", "bucket_loop_lazy", "merge_lazy")},
                               f"the 2^{k} MSM's signed call and its SRS", imad_per_s, "steps")
        else:
            require(counts["bucket_loop"] == 1 and counts["g1_madd_packed"] == 0,
                    "the unsigned route did not run its bucket loop in one launch")
            loop_args = cap.captured("bucket_loop")["bucket_loop"]
            check_loop_kernels({"bucket_loop": loop_args}, f"the 2^{k} MSM's unsigned call",
                               imad_per_s, "steps")
            time_bucket_floor(loop_args)


def time_bucket_floor(args) -> None:
    """The unsigned bucket loop's serial floor on its lane table: one block
    of the 128 longest lanes alone, whose time is the longest lane's adds
    times one add's latency with its SM to itself."""
    import torch

    from paillier_halo2_tpu_torch.ec import point_kernels as pk

    packed, order, seg, count, sub, nsub, win, _, n = args
    m = 128
    lone_args = (packed, order, *(t[:m].contiguous() for t in (seg, count, sub, nsub, win)),
                 torch.arange(m, dtype=torch.int32, device=packed.device), n)
    need = int(pk._need(count[:m].long(), sub[:m].long(), nsub[:m].long()).max())
    lone = device_ms(lambda: pk.bucket_loop(*lone_args), 3, "g1_bucket_kernel")
    log(f"    bucket loop serial floor: one block of the {m} longest lanes alone ({need} adds "
        f"at most) {lone} ms on the device ({lone * 1e3 / need if lone else None} us an add)")


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


# -- phases 8 and 9: the MockProver ------------------------------------------------


def mock_bytes(gates: int, lookups: int, copies: int, consts: int) -> int:
    """Bytes a device check must move: each index read once (int64), the
    limb rows it gathers (4 a gate, 1 a lookup or constant, 2 a copy; 32 B
    each), the constants' limbs, and one mask byte written per check."""
    checks = gates + lookups + copies + consts
    return (8 * (checks + copies) + 32 * (4 * gates + lookups + 2 * copies + consts)
            + 32 * consts + checks)


def same_mock(a, b) -> bool:
    """Two MockResults agree field for field, arrays in order."""
    import numpy as np

    return a.satisfied == b.satisfied and all(
        np.array_equal(getattr(a, name), getattr(b, name))
        for name in ("gate_failures", "lookup_failures", "copy_failures", "const_failures"))


def run_mock(dev, label: str, fn):
    """fn(stats) on the card with the launch counts and the peak memory
    reset first; prints the run's line; returns (result, stats, K1
    launches)."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    stats: dict = {}
    t0 = time.monotonic()
    res = fn(stats)
    wall = time.monotonic() - t0
    k1 = read_counts()["mont_mul"]
    on_card = (stats["copies"], stats["consts"]) if stats["route"] == "one-shot" else (0, 0)
    nbytes = mock_bytes(stats["gates"], stats["lookups"], *on_card)
    where = stats.get("why") or f"{stats['chunks']} chunks of {stats['chunk_rows']} rows"
    host = f", copies and constants on the host {stats['host_s']:.3f} s" if "host_s" in stats else ""
    log(f"  {label}: {stats['rows']} rows, {stats['gates']} gates, {stats['lookups']} lookups, "
        f"{stats['copies']} copies, {stats['consts']} constants; route {stats['route']} ({where}); "
        f"pack {stats['pack_s']:.3f} s, device check {stats['check_ms']:.3f} ms (CUDA events){host}, "
        f"wall {wall:.3f} s; memory bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B over "
        f"3.35 TB/s); K1 launches {k1}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return res, stats, k1


def mock_reference_inputs():
    """The reference's two MockProver tests (tests/test_gadgets.py:75-110):
    (label, circuit, input), drawn from its module RNG in file order (the
    ENC=32 encryption first, then ENC=128, then ENC=264)."""
    from paillier_halo2_tpu_torch.bignum.host import paillier_add_native, paillier_enc_native
    from paillier_halo2_tpu_torch.harness.circuits import (
        PaillierAddCipherInput,
        PaillierEncryptionInput,
        paillier_enc_add_test,
        paillier_enc_test,
    )

    rng = random.Random(MOCK_SEED)

    def draw(enc):
        n = rng.getrandbits(enc) | 1
        return n, *(rng.getrandbits(enc) for _ in range(3))

    draw(32)
    n, g, m, r = draw(128)
    enc = PaillierEncryptionInput(128, 64, n, g, m, r, paillier_enc_native(n, g, m, r))
    n, g, c1, c2 = draw(264)
    add = PaillierAddCipherInput(88, 264, n, g, c1, c2, paillier_add_native(n, c1, c2))
    return [("encryption ENC=128/LIMB=64", paillier_enc_test, enc),
            ("addition ENC=264/LIMB=88", paillier_enc_add_test, add)]


def big_enc_table(enc: int):
    """tests/test_big_geometry.py's encryption table at `enc` bits (LIMB=64,
    lookup_bits=15; its RNG's first draw)."""
    from paillier_halo2_tpu_torch.bignum.host import paillier_enc_native
    from paillier_halo2_tpu_torch.gadgets.context import Context
    from paillier_halo2_tpu_torch.gadgets.range import RangeChip
    from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test

    rng = random.Random(BIG_SEED)
    n = rng.getrandbits(enc) | (1 << (enc - 1)) | 1
    g, m, r = (rng.getrandbits(enc) for _ in range(3))
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, MOCK_LOOKUP_BITS), PaillierEncryptionInput(
        enc, BIG_LIMB, n, g, m, r, paillier_enc_native(n, g, m, r)))
    return ctx.finalize()


def tamper(table, chunk_rows: int, seed: int = 8):
    """A copy of `table` with 16 values set to v + 1 mod p: a gate row, a
    lookup row (one at 2^15 - 1 where there is one, so it leaves the
    range), a copy row, a constant row, the first row of one chunk, the
    three overlap rows after another chunk's end, and 8 random rows."""
    import numpy as np

    from paillier_halo2_tpu_torch.ff.host import FR_MOD
    from paillier_halo2_tpu_torch.gadgets.context import VirtualTable

    rng = np.random.default_rng(seed)
    vals = table.values
    top = table.lookups[vals[table.lookups] == (1 << MOCK_LOOKUP_BITS) - 1]
    lookup_rows = top if len(top) else table.lookups
    b1, b2 = rng.choice(np.arange(1, -(-table.n_rows // chunk_rows)), 2, replace=False)
    rows = [int(table.gates[rng.integers(len(table.gates))]) + int(rng.integers(4)),
            int(lookup_rows[rng.integers(len(lookup_rows))]),
            int(table.copy_a[rng.integers(len(table.copy_a))]),
            int(table.const_idx[rng.integers(len(table.const_idx))]),
            int(b1) * chunk_rows, *(int(b2) * chunk_rows + i for i in range(3)),
            *(int(x) for x in rng.integers(0, table.n_rows, 8))]
    bad = vals.copy()
    for r in rows:
        bad[r] = (int(bad[r]) + 1) % FR_MOD
    return VirtualTable(bad, table.gates, table.copy_a, table.copy_b, table.const_idx,
                        table.const_val, table.lookups), rows


def run_mock_phase(dev) -> dict:
    """Phase 8. Returns K1's kernels-line entry: the check's b*c operands
    held against the plain version and timed, and K1's launches over the
    phase's runs."""
    import torch

    from paillier_halo2_tpu_torch.ff import mulmod
    from paillier_halo2_tpu_torch.harness.base_test import base_test
    from paillier_halo2_tpu_torch.mock import prover as mock

    launches = 0
    for label, circuit, inp in mock_reference_inputs():
        tester = (base_test().k(MOCK_K).lookup_bits(MOCK_LOOKUP_BITS).expect_satisfied(True)
                  .device(dev))
        out, _, k1 = run_mock(dev, f"{label}, k={MOCK_K}", lambda st: tester.run(
            lambda ctx, rc: circuit(ctx, rc, inp), stats=st))
        launches += k1
        require(same_mock(out.mock, mock.mock_prove_host(out.table, MOCK_LOOKUP_BITS)),
                f"the {label} MockProver differs from the host oracle")
        log(f"    satisfied, equal to mock_prove_host field for field; synthesis "
            f"{out.synth_time_s:.3f} s, {out.config}")

    t0 = time.monotonic()
    table = big_enc_table(BIG_ENC)
    log(f"  {BIG_ENC}-bit encryption table synthesized in {time.monotonic() - t0:.3f} s")
    lk = MOCK_LOOKUP_BITS
    with CaptureCall(mulmod, "mont_mul", 1) as cap:  # call 0: to_mont(b); 1: b*c
        one, st, k1 = run_mock(dev, f"{BIG_ENC}-bit one-shot", lambda st: mock.mock_prove_torch(
            table, lk, device=dev, stats=st))
    launches += k1
    require(st["route"] == "one-shot", f"the {BIG_ENC}-bit table did not fit the card one-shot")
    chk, _, k1 = run_mock(dev, f"{BIG_ENC}-bit chunked", lambda st: mock.mock_prove_chunked(
        table, lk, chunk_rows=BIG_CHUNK_ROWS, device=dev, stats=st))
    launches += k1
    require(one.satisfied and chk.satisfied, f"the {BIG_ENC}-bit MockProver is not satisfied")

    bad, rows = tamper(table, BIG_CHUNK_ROWS)
    log(f"  tampered rows: {rows}")
    one_b, _, k1 = run_mock(dev, f"{BIG_ENC}-bit tampered, one-shot",
                            lambda st: mock.mock_prove_torch(bad, lk, device=dev, stats=st))
    launches += k1
    chk_b, _, k1 = run_mock(dev, f"{BIG_ENC}-bit tampered, chunked", lambda st: mock.mock_prove_chunked(
        bad, lk, chunk_rows=BIG_CHUNK_ROWS, device=dev, stats=st))
    launches += k1
    t0 = time.monotonic()
    host = mock.mock_prove_host(bad, lk)
    host_s = time.monotonic() - t0
    require(not host.satisfied, "the tampered table satisfies the host oracle")
    require(same_mock(one_b, host) and same_mock(chk_b, host),
            "the tampered table's failures differ between one-shot, chunked and the host oracle")
    log(f"    failures equal on one-shot, chunked and host (host oracle {host_s:.3f} s): " + "; ".join(
        f"{name} {len(a)} (first {a[:8].tolist()})" for name, a in (
            ("gates", host.gate_failures), ("lookups", host.lookup_failures),
            ("copies", host.copy_failures), ("constants", host.const_failures))))

    spec, a, b = cap.args
    require(a.shape[1] == min(len(table.gates), mock.SLICE), "the captured call is not b*c")
    out, ref = mulmod.mont_mul(spec, a, b), mulmod.mont_mul_plain(spec, a, b)
    torch.cuda.synchronize()
    err = max_abs_err([out], [ref])
    require(torch.equal(out, ref), "mont_mul differs from its plain version on the MockProver's b*c")
    entry = {"max_abs_err": err, "lanes": a.shape[1], "double_lanes": 0, "launches": launches,
             "ms": cuda_ms(lambda: mulmod.mont_mul(spec, a, b), 20),
             "plain_ms": cuda_ms(lambda: mulmod.mont_mul_plain(spec, a, b), 3),
             "device_ms": device_ms(lambda: mulmod.mont_mul(spec, a, b), 10, "mont_mul_kernel<pht::Fr>")}
    log(f"  K1 on the {BIG_ENC}-bit check's b*c ({a.shape[1]} lanes): equal to its plain version "
        f"(max_abs_err {err}); kernel {entry['ms']} ms per call ({entry['device_ms']} ms on the "
        f"device), plain {entry['plain_ms']} ms; K1 launches over phase 8: {launches}")
    return entry


def run_config1(dev) -> None:
    """Phase 9: BASELINE.json config 1, the 2048-bit encryption MockProver."""
    import resource

    import torch
    from torch.profiler import ProfilerActivity, profile

    from paillier_halo2_tpu_torch.mock import prover as mock

    with open("/proc/meminfo") as fh:
        avail = next(int(line.split()[1]) * 1024 for line in fh if line.startswith("MemAvailable:"))
    log(f"  host MemAvailable {avail / 2**30:.2f} GiB; this run needs about "
        f"{CONFIG1_HOST_BYTES / 2**30:.0f} GiB")
    require(avail >= CONFIG1_HOST_BYTES,
            f"the host has {avail / 2**30:.2f} GiB available, below the "
            f"{CONFIG1_HOST_BYTES / 2**30:.0f} GiB the {CONFIG1_ENC}-bit run needs")
    t0 = time.monotonic()
    table = big_enc_table(CONFIG1_ENC)
    log(f"  {CONFIG1_ENC}-bit encryption table synthesized in {time.monotonic() - t0:.3f} s")
    res, _, _ = run_mock(dev, f"{CONFIG1_ENC}-bit", lambda st: mock.mock_prove_torch(
        table, MOCK_LOOKUP_BITS, device=dev, stats=st))
    res.assert_satisfied()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  peak host RSS {rss / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res, _, _ = run_mock(dev, f"{CONFIG1_ENC}-bit again, under torch.profiler",
                             lambda st: mock.mock_prove_torch(table, MOCK_LOOKUP_BITS, device=dev,
                                                              stats=st))
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    log(f"  device time {sum(r[0] for r in rows) / 1e3:.3f} ms; by kernel: " + "; ".join(
        f"{key[:70]} {count} launches {us / 1e3:.3f} ms" for us, count, key in rows[:8]))
    res.assert_satisfied()
    torch.cuda.synchronize()


# -- phase 10: proving keys saved and loaded, GWC, instance columns -------------------


class CountCalls:
    """While active, counts the calls of `module.name`."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seen = module, name, 0

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            self.seen += 1
            return fn(*args, **kwargs)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class CaptureLargest(CaptureCall):
    """While active, keeps a copy of the arguments of the call of
    `module.name` whose third argument has the most elements (K1's
    (spec, a, b))."""

    def __init__(self, module, name: str):
        super().__init__(module, name, -1)

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            if self.args is None or args[2].numel() > self.args[2].numel():
                self.args = _clone(args)
            self.seen += 1
            return fn(*args)

        setattr(self.module, self.name, wrapped)
        return self


def timed(fn):
    """(fn(), seconds), the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def instance_table(fx):
    """`tests/test_instance.py`'s statement: the encryption checked in the
    circuit, then n, g and the ciphertext limbs exposed as public inputs."""
    from paillier_halo2_tpu_torch.gadgets import (
        BigUintChip,
        Context,
        EncryptionPublicKeyAssigned,
        PaillierChip,
    )
    from paillier_halo2_tpu_torch.gadgets.range import RangeChip

    enc, limb, x = fx["enc_bits"], fx["limb_bits"], fx["inputs"]
    ctx = Context()
    bu = BigUintChip(RangeChip(ctx, fx["lookup_bits"]), limb)
    pc = PaillierChip.construct(bu, enc)
    n_a, g_a = bu.assign_integer(x["n"], enc), bu.assign_integer(x["g"], enc)
    c = pc.encrypt(EncryptionPublicKeyAssigned(n_a, g_a), bu.assign_integer(x["m"], enc),
                   bu.assign_integer(x["r"], enc))
    res_a = bu.assign_integer(x["res"], enc * 2)
    bu.assert_equal_fresh(c, res_a)
    for cells in (n_a.limbs, g_a.limbs, res_a.limbs):
        ctx.expose_public(cells)
    return ctx.finalize()


def check_instance_fixture(dev) -> None:
    from paillier_halo2_tpu_torch.plonk.keygen import keygen
    from paillier_halo2_tpu_torch.plonk.prover import create_proof
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    fx = torch_fixture("instance_enc_k10.json")
    table = instance_table(fx)
    publics = table.public_values()
    require(publics == fx["publics"], "the instance statement's public values differ from the fixture")
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), dev)
    pk = keygen(table, fx["k"], fx["lookup_bits"], srs)
    proof = create_proof(pk, table, fx["blinding_seed"].encode())
    require(pk.vk.num_instance == 1, "the instance statement has no instance column")
    require(proof.hex() == fx["proof_hex"], "K=10 instance proof differs from instance_enc_k10.json")
    require(verify_proof(pk.vk, srs, proof, instances=publics), "K=10 instance proof does not verify")
    bad = list(publics)
    bad[-1] = (bad[-1] + 1) % (1 << fx["limb_bits"])
    require(not verify_proof(pk.vk, srs, proof, instances=bad),
            "K=10 instance proof verifies with a ciphertext limb changed")
    try:
        verify_proof(pk.vk, srs, proof)
        refused = False
    except ValueError:
        refused = True
    require(refused, "the verifier took an instance proof without its public values")
    log(f"  K=10 instance proof: {len(proof)} bytes, {len(publics)} public values, byte-identical "
        "to instance_enc_k10.json, verified; rejected with a ciphertext limb changed; refused "
        "without instances=")


def add_input():
    from paillier_halo2_tpu_torch.bignum.host import paillier_add_native
    from paillier_halo2_tpu_torch.harness.circuits import PaillierAddCipherInput

    prng = random.Random(ADD_SEED)  # bench_add.py's inputs
    n = prng.getrandbits(ADD_ENC) | (1 << (ADD_ENC - 1)) | 1
    g, c1, c2 = (prng.getrandbits(ADD_ENC) for _ in range(3))
    return PaillierAddCipherInput(limb_bits=ADD_LIMB, enc_bits=ADD_ENC, n=n, g=g, c1=c1, c2=c2,
                                  res=paillier_add_native(n, c1, c2))


def run_key_path(dev, label: str, circuit, inp, srs, key_dir: str, multiopen: str):
    """Synthesis, fingerprint, keygen, save, load under the fingerprint,
    proof from the loaded key, verify against the fresh key's verifying key;
    prints the seconds and bytes. Returns (table, fresh pk, loaded pk, proof)."""
    import torch

    from paillier_halo2_tpu_torch.gadgets.context import Context
    from paillier_halo2_tpu_torch.gadgets.range import RangeChip
    from paillier_halo2_tpu_torch.plonk.keygen import keygen
    from paillier_halo2_tpu_torch.plonk.prover import create_proof
    from paillier_halo2_tpu_torch.plonk.serialize import (
        load_proving_key,
        save_proving_key,
        table_fingerprint,
    )
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    torch.cuda.reset_peak_memory_stats(dev)

    def synth():
        ctx = Context()
        circuit(ctx, RangeChip(ctx, MAIN_LOOKUP_BITS), inp)
        return ctx.finalize()

    table, t_synth = timed(synth)
    fp, t_fp = timed(lambda: table_fingerprint(table, MAIN_K, MAIN_LOOKUP_BITS, multiopen))
    pk, t_keygen = timed(lambda: keygen(table, MAIN_K, MAIN_LOOKUP_BITS, srs, multiopen=multiopen))
    path = os.path.join(key_dir, f"pk_{label}_k{MAIN_K}_{multiopen}.npz")
    _, t_save = timed(lambda: save_proving_key(pk, path, table_fp=fp))
    pk2, t_load = timed(lambda: load_proving_key(path, srs, expect_table_fp=fp, device=dev))
    proof, t_proof = timed(lambda: create_proof(pk2, table, PHASE10_BLIND))
    ok, t_verify = timed(lambda: verify_proof(pk.vk, srs, proof))
    require(ok, f"the {label} proof from the loaded key does not verify")
    require(pk2.vk.multiopen == multiopen and pk2.vk == pk.vk,
            f"the loaded {label} key's verifying key differs from the saved one")
    log(f"  {label}, k={MAIN_K}, {multiopen}: {table.n_rows} rows, {pk.vk.num_advice} advice + "
        f"{pk.vk.num_lookup_advice} lookup-advice columns; synthesis {t_synth:.4f} s, fingerprint "
        f"{t_fp:.4f} s, keygen {t_keygen:.4f} s, save {t_save:.4f} s, load {t_load:.4f} s, proof "
        f"(loaded key) {t_proof:.4f} s, verify {t_verify:.4f} s; key file {os.path.getsize(path)} "
        f"bytes, proof {len(proof)} bytes; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return table, pk, pk2, proof, path, fp


def run_key_phase(dev, params_dir: str, srs_generated_here: bool, imad_per_s: float) -> list:
    """Phase 10 (c) and (d); returns the kernels-line entries of the path's
    kernels, their launches counted over (c) and (d)."""
    import torch

    from paillier_halo2_tpu_torch.ff import mulmod
    from paillier_halo2_tpu_torch.harness.circuits import paillier_enc_add_test, paillier_enc_test
    from paillier_halo2_tpu_torch.msm import pippenger
    from paillier_halo2_tpu_torch.plonk import kzg
    from paillier_halo2_tpu_torch.plonk.prover import create_proof
    from paillier_halo2_tpu_torch.plonk.serialize import load_proving_key, table_fingerprint
    from paillier_halo2_tpu_torch.plonk.srs import read_or_create_srs
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    key_dir = os.path.join(ROOT, "build", "chip_smoke_keys")
    shutil.rmtree(key_dir, ignore_errors=True)
    os.makedirs(key_dir)
    torch.cuda.synchronize()
    zero_counts()
    with (LoopCaptures() as cap, CaptureLargest(mulmod, "mont_mul") as k1_cap,
          CountCalls(kzg, "msm_packed_multi") as msm_calls,
          CountCalls(pippenger, "_signed_keys") as passes):
        srs, t_srs = timed(lambda: read_or_create_srs(MAIN_K, device=dev, params_dir=params_dir))
        log(f"  SRS k={MAIN_K} {'generated' if srs_generated_here else 'loaded from phase 5'} "
            f"in {t_srs:.4f} s")
        # (c) bench_add.py's path, the proof from the loaded key
        table, pk, _, proof, path, _ = run_key_path(dev, "add", paillier_enc_add_test, add_input(),
                                                   srs, key_dir, "shplonk")
        fresh, t_fresh = timed(lambda: create_proof(pk, table, PHASE10_BLIND))
        require(fresh == proof, "the add proof from the loaded key differs from the fresh key's")
        other = table_fingerprint(table, MAIN_K, MAIN_LOOKUP_BITS, "gwc")
        try:
            load_proving_key(path, srs, expect_table_fp=other, device=dev)
            refused = False
        except ValueError:
            refused = True
        require(refused, "a load under another fingerprint did not raise")
        log(f"    byte-identical to the fresh key's proof ({t_fresh:.4f} s); a load expecting "
            "another fingerprint raised ValueError")
        # (d) phase 5's circuit under GWC
        table, pk, pk2, proof, _, _ = run_key_path(dev, "enc", paillier_enc_test, main_input(), srs,
                                                   key_dir, "gwc")
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        require(not verify_proof(pk.vk, srs, bytes(bad)), "a tampered k=14 GWC proof verifies")
        require(pk2.vk.multiopen == "gwc", "the loaded encryption key is not GWC")
        log("    tampered copy rejected; the saved key loads back as gwc")
    counts = read_counts()
    log(f"  launches over (c) and (d): {counts}; {msm_calls.seen} MSM calls in "
        f"{passes.seen} bucket passes")
    loops = ("bucket_loop_lazy", "merge_lazy", "window_sums")
    require(msm_calls.seen > 0 and all(counts[name] == passes.seen for name in loops),
            "phase 10 did not launch each loop kernel once per bucket pass")
    require(all(counts[name] == 0 for name in
                ("g1_madd", "padd_mixed_packed_lazy", "padd_lazy", "g1_jadd")),
            "phase 10 launched a K3, K5, K6 or K2 step")
    require(counts["fixed_base_comb"] == int(srs_generated_here),
            "phase 10's comb launches do not match where its SRS came from")
    require(counts["mont_mul"] > 0, "phase 10 launched no K1")

    names = [*loops, *(["fixed_base_comb"] if srs_generated_here else [])]
    results = check_loop_kernels(cap.captured(*names), "phase 10's first MSM call", imad_per_s)
    spec, a, b = k1_cap.args
    out, ref = mulmod.mont_mul(spec, a, b), mulmod.mont_mul_plain(spec, a, b)
    torch.cuda.synchronize()
    require(torch.equal(out, ref), "mont_mul differs from its plain version on phase 10's operands")
    results["mont_mul"] = {
        "max_abs_err": max_abs_err([out], [ref]), "lanes": a.shape[1], "double_lanes": 0,
        "ms": cuda_ms(lambda: mulmod.mont_mul(spec, a, b), 20),
        "plain_ms": cuda_ms(lambda: mulmod.mont_mul_plain(spec, a, b), 3),
        "device_ms": device_ms(lambda: mulmod.mont_mul(spec, a, b), 10, "mont_mul_kernel")}
    log(f"  K1 on phase 10's widest operands ({a.shape[1]} lanes): equal to its plain version; "
        f"kernel {results['mont_mul']['ms']} ms per call ({results['mont_mul']['device_ms']} ms "
        f"on the device), plain {results['mont_mul']['plain_ms']} ms")
    return [kernel_entry(name, results[name], counts[name],
                         "phase 10, key save/load and GWC at k=14", imad_per_s)
            for name in ("mont_mul", *names)]


# -- phase 11: the mesh layer and the distributed prover ------------------------------


def phase11_mesh(dev):
    """`make_mesh(MESH_SHARDS, "cuda:0")`, or one shard a card (a power of
    two of them) where the machine has two or more cards."""
    import torch

    from paillier_halo2_tpu_torch.mesh.sharding import make_mesh

    n = torch.cuda.device_count()
    return make_mesh(1 << (n.bit_length() - 1), "cuda") if n >= 2 else make_mesh(MESH_SHARDS, dev)


def tree_levels(mesh) -> int:
    """K2 launches of one cross-shard reduction: halving levels, each axis."""
    levels = 0
    for m in mesh.shape:
        while m > 1:
            m, levels = (m + 1) // 2, levels + 1
    return levels


def random_fr(shape, dev, seed: int):
    """Canonical Fr limb tensors (top limb below p's), from a seeded generator."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-2**31, 2**31, shape, generator=g, dtype=torch.int32, device=dev)
    x[7] &= 0x0FFFFFFF
    return x


def check_mesh_ntt(mesh, dev) -> None:
    """The four-step NTT at k=14 and at the main path's extended k, both
    directions, bit-equal to `poly/ntt.ntt`, each timed beside it."""
    import torch

    from paillier_halo2_tpu_torch.mesh.ntt import ntt_natural
    from paillier_halo2_tpu_torch.plonk.keygen import EXTENDED_RATE_BITS
    from paillier_halo2_tpu_torch.poly.ntt import ntt

    for k, batch in ((MAIN_K, 4), (MAIN_K + EXTENDED_RATE_BITS, 2)):
        x = random_fr((8, batch, 1 << k), dev, k)
        for inverse in (False, True):
            got, want = ntt_natural(mesh, x, k, inverse), ntt(x, k, inverse)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"the four-step NTT differs from the single-device NTT (k={k}, inverse={inverse})")
            ms = cuda_ms(lambda: ntt_natural(mesh, x, k, inverse), 3)
            single_ms = cuda_ms(lambda: ntt(x, k, inverse), 3)
            log(f"  NTT k={k} x{batch} {'inverse' if inverse else 'forward'}: four-step over "
                f"{mesh.size} shards equal to the single-device NTT; {ms} ms per call "
                f"(single device {single_ms} ms)")


def check_tree_k2(tree, where: str) -> dict:
    """K2 on one captured tree level against its plain version, timed;
    returns a results entry (the doubling lanes counted from the inputs)."""
    import torch

    from paillier_halo2_tpu_torch.ec import point_kernels as pk
    from paillier_halo2_tpu_torch.ff import field as f

    require(tree.args is not None, f"no K2 tree level was captured ({where})")
    args, kw = tree.args, tree.kwargs
    require(not kw.get("nodouble", False), "the cross-shard tree did not take the full add")
    out, ref = pk.g1_jadd(*args, **kw), pk.g1_jadd_plain(*args, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(o, r) for o, r in zip(out, ref)),
            f"K2 differs from its plain version on the cross-shard tree ({where})")
    X1, Y1, Z1, X2, Y2, Z2 = args
    mul = lambda a, b: f.mont_mul(f.FQ, a, b)  # noqa: E731
    z1z1, z2z2 = mul(Z1, Z1), mul(Z2, Z2)
    finite = ~f.is_zero(Z1) & ~f.is_zero(Z2)
    same = (f.is_zero(f.sub(f.FQ, mul(X1, z2z2), mul(X2, z1z1)))
            & f.is_zero(f.sub(f.FQ, mul(Y1, mul(Z2, z2z2)), mul(Y2, mul(Z1, z1z1)))))
    entry = {"max_abs_err": max_abs_err(out, ref), "lanes": X1.shape[1],
             "double_lanes": int((finite & same).sum()),
             "ms": cuda_ms(lambda: pk.g1_jadd(*args, **kw), 20),
             "plain_ms": cuda_ms(lambda: pk.g1_jadd_plain(*args, **kw), 3),
             "device_ms": device_ms(lambda: pk.g1_jadd(*args, **kw), 10, "g1_jadd_kernel<false>")}
    log(f"    K2 on a tree level of {where} ({entry['lanes']} lanes, {entry['double_lanes']} "
        f"doubling): equal to its plain version (max_abs_err {entry['max_abs_err']}); kernel "
        f"{entry['ms']} ms per call ({entry['device_ms']} ms on the device), plain "
        f"{entry['plain_ms']} ms")
    return entry


def check_mesh_msm(mesh, dev) -> None:
    """The sharded MSM at 2^14 and 2^20 on the seed-b"" SRS with bench.py's
    scalars, equal to the fixtures; its launches, warm time and device time
    beside the unsharded signed route's in the same call; K2 held against
    its plain version on the 2^20 call's first tree level."""
    import torch

    from paillier_halo2_tpu_torch.ec import point_kernels as pk
    from paillier_halo2_tpu_torch.mesh.msm import msm_sharded
    from paillier_halo2_tpu_torch.msm.pippenger import msm_packed
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    shown = ("bucket_loop_lazy", "merge_lazy", "g1_jadd", "window_sums", "padd_mixed_packed_lazy",
             "padd_lazy", "mont_mul")
    for k in MESH_MSM_KS:
        n = 1 << k
        srs, t_srs = timed(lambda: generate_srs(k, b"", dev))
        sd = bench_scalars(k, dev)
        want = msm_fixture(k)
        bases = (srs.g1_px, srs.g1_py, srs.g1_inf)
        with CaptureCall(pk, "g1_jadd", 0) as tree:
            first, t_first = timed(lambda: msm_sharded(mesh, *bases, sd))
        for label, fn in (("sharded", lambda: msm_sharded(mesh, *bases, sd)),
                          ("unsharded signed", lambda: msm_packed(*bases, sd, signed=True))):
            zero_counts()
            got, t_warm = timed(fn)
            counts = read_counts()
            require(got == want and first == want,
                    f"2^{k} MSM ({label}) differs from params_fixtures/bench_msm_expected_{k}.json")
            if label == "sharded":
                require(counts["bucket_loop_lazy"] == counts["merge_lazy"] == mesh.size,
                        "the sharded MSM did not run one bucket loop and one merge a shard")
                require(counts["g1_jadd"] == tree_levels(mesh) and counts["window_sums"] == 1,
                        "the sharded MSM did not reduce its shards in one K2 launch a tree level "
                        "and sum its windows in one launch")
                require(counts["padd_mixed_packed_lazy"] == counts["padd_lazy"] == 0,
                        "the sharded MSM launched a K5 or K6 step")
            log(f"  MSM 2^{k} {label} ({mesh.size} shards on {mesh.n_cards} card(s); SRS made in "
                f"{t_srs:.3f} s): equals the fixture; first {t_first:.4f} s, warm {t_warm:.4f} s = "
                f"{n / t_warm:.1f} points/s; launches {({name: counts[name] for name in shown})}")
            log(f"    profile of another call: {profile_call(fn, t_warm)}")
        if k == MESH_MSM_KS[-1]:
            check_tree_k2(tree, f"the 2^{k} sharded MSM")


def check_mesh_slice(mesh, dev) -> None:
    """Phase 4's K=10 proof through `keygen_sharded` and
    `create_proof_sharded`: byte-identical to the JAX fixture, verified."""
    from paillier_halo2_tpu_torch.gadgets.context import Context
    from paillier_halo2_tpu_torch.gadgets.range import RangeChip
    from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
    from paillier_halo2_tpu_torch.mesh import msm as mesh_msm
    from paillier_halo2_tpu_torch.plonk.distributed import create_proof_sharded, keygen_sharded
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    fx = torch_fixture("slice_enc_k10.json")
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"], **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    table = ctx.finalize()
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), dev)
    with CountCalls(mesh_msm, "msm_sharded_multi") as calls:
        pk, t_kg = timed(lambda: keygen_sharded(mesh, table, fx["k"], fx["lookup_bits"], srs))
        proof, t_pr = timed(lambda: create_proof_sharded(mesh, pk, table, fx["blinding_seed"].encode()))
    require(calls.seen >= 5, f"the sharded K=10 prover ran the sharded MSM {calls.seen} times")
    require(proof.hex() == fx["proof_hex"], "the sharded K=10 proof differs from slice_enc_k10.json")
    require(verify_proof(pk.vk, srs, proof), "the sharded K=10 proof does not verify")
    log(f"  K=10 proof over {mesh.size} shards: byte-identical to slice_enc_k10.json, verified; "
        f"{calls.seen} sharded MSM calls; keygen {t_kg:.4f} s, proof {t_pr:.4f} s")


def run_mesh_main_path(mesh, dev, params_dir: str, imad_per_s: float) -> list:
    """Phase 5's circuit at full width through `keygen_sharded` and
    `create_proof_sharded`: the verifying key and the proof bytes equal the
    single-device ones with the same blinding seed, and the proof verifies.
    Launches are counted over the sharded keygen and proof; the loop
    kernels are held against their plain versions on the first sharded MSM
    call's first shard, K2 on its first tree level, K1 on the widest
    operands. Returns the kernels-line entries."""
    import torch

    from paillier_halo2_tpu_torch.ec import point_kernels as pk
    from paillier_halo2_tpu_torch.ff import mulmod
    from paillier_halo2_tpu_torch.gadgets.context import Context
    from paillier_halo2_tpu_torch.gadgets.range import RangeChip
    from paillier_halo2_tpu_torch.harness.circuits import paillier_enc_test
    from paillier_halo2_tpu_torch.mesh import msm as mesh_msm
    from paillier_halo2_tpu_torch.msm import pippenger
    from paillier_halo2_tpu_torch.plonk.distributed import create_proof_sharded, keygen_sharded
    from paillier_halo2_tpu_torch.plonk.keygen import keygen
    from paillier_halo2_tpu_torch.plonk.prover import create_proof
    from paillier_halo2_tpu_torch.plonk.srs import read_or_create_srs
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    srs, t_srs = timed(lambda: read_or_create_srs(MAIN_K, device=dev, params_dir=params_dir))
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, MAIN_LOOKUP_BITS), main_input())
    table = ctx.finalize()
    pk1, t_kg = timed(lambda: keygen(table, MAIN_K, MAIN_LOOKUP_BITS, srs))
    proof, t_pr = timed(lambda: create_proof(pk1, table, PHASE11_BLIND))
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    with (LoopCaptures() as cap, CaptureCall(pk, "g1_jadd", 0) as tree,
          CaptureLargest(mulmod, "mont_mul") as k1_cap,
          CountCalls(mesh_msm, "msm_sharded_multi") as calls,
          CountCalls(pippenger, "_signed_keys") as passes):
        pk_s, t_kgs = timed(lambda: keygen_sharded(mesh, table, MAIN_K, MAIN_LOOKUP_BITS, srs))
        proof_s, t_prs = timed(lambda: create_proof_sharded(mesh, pk_s, table, PHASE11_BLIND))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ok, t_verify = timed(lambda: verify_proof(pk_s.vk, srs, proof_s))
    log(f"  k={MAIN_K} ENC={MAIN_ENC}/LIMB={MAIN_LIMB} ({table.n_rows} rows; SRS in {t_srs:.4f} "
        f"s) over {mesh.size} shards on {mesh.n_cards} card(s): keygen {t_kgs:.4f} s (single "
        f"device {t_kg:.4f} s), proof {t_prs:.4f} s (single device {t_pr:.4f} s), verify "
        f"{t_verify:.4f} s, {len(proof_s)} bytes; peak device memory {peak:.3f} GiB over the "
        f"sharded keygen and proof; {calls.seen} sharded MSM calls in {passes.seen} bucket passes")
    log(f"  launches over the sharded keygen and proof: {counts}")
    require(pk_s.vk.fixed_commitments() == pk1.vk.fixed_commitments(),
            "the sharded verifying key's commitments differ from single-device keygen's")
    require(proof_s == proof, "the sharded k=14 proof differs from the single-device proof")
    require(ok, "the sharded k=14 proof does not verify")
    loops = ("bucket_loop_lazy", "merge_lazy")
    require(calls.seen > 0 and all(counts[name] == mesh.size * passes.seen for name in loops),
            "the sharded prover did not run one bucket loop and one merge a shard per bucket pass")
    require(counts["window_sums"] == passes.seen and
            counts["g1_jadd"] == tree_levels(mesh) * passes.seen,
            "the sharded prover did not sum windows once and reduce shards in one K2 launch a "
            "tree level per bucket pass")
    require(all(counts[name] == 0 for name in
                ("g1_madd", "padd_mixed_packed_lazy", "padd_lazy", "fixed_base_comb")),
            "the sharded prover launched a K3, K5 or K6 step or the comb")
    require(counts["mont_mul"] > 0, "the sharded prover launched no K1")

    where = f"phase 11's first sharded MSM call (shard 0 of {mesh.size})"
    results = check_loop_kernels(cap.captured(*loops, "window_sums"), where, imad_per_s)
    results["g1_jadd"] = check_tree_k2(tree, "phase 11's first sharded MSM call")
    spec, a, b = k1_cap.args
    out, ref = mulmod.mont_mul(spec, a, b), mulmod.mont_mul_plain(spec, a, b)
    torch.cuda.synchronize()
    require(torch.equal(out, ref), "mont_mul differs from its plain version on phase 11's operands")
    results["mont_mul"] = {
        "max_abs_err": max_abs_err([out], [ref]), "lanes": a.shape[1], "double_lanes": 0,
        "ms": cuda_ms(lambda: mulmod.mont_mul(spec, a, b), 20),
        "plain_ms": cuda_ms(lambda: mulmod.mont_mul_plain(spec, a, b), 3),
        "device_ms": device_ms(lambda: mulmod.mont_mul(spec, a, b), 10, "mont_mul_kernel")}
    log(f"  K1 on phase 11's widest operands ({a.shape[1]} lanes): equal to its plain version; "
        f"kernel {results['mont_mul']['ms']} ms per call ({results['mont_mul']['device_ms']} ms "
        f"on the device), plain {results['mont_mul']['plain_ms']} ms")
    where = f"phase 11, the k=14 proof sharded over {mesh.size} shards"
    return [kernel_entry(name, results[name], counts[name], where, imad_per_s)
            for name in ("mont_mul", *loops, "window_sums", "g1_jadd")]


def run_mesh_phase(dev, params_dir: str, srs_generated_here: bool, imad_per_s: float) -> list:
    """Phase 11; returns the kernels-line entries of its main-path run."""
    from paillier_halo2_tpu_torch.entry import dryrun_multichip

    mesh = phase11_mesh(dev)
    log(f"  mesh: {mesh.size} shards on {mesh.n_cards} card(s) "
        f"({', '.join(str(d) for d in mesh.devices)})")
    if srs_generated_here:
        shutil.rmtree(params_dir, ignore_errors=True)  # the SRS is generated here
    check_mesh_ntt(mesh, dev)
    check_mesh_msm(mesh, dev)
    check_mesh_slice(mesh, dev)
    entries = run_mesh_main_path(mesh, dev, params_dir, imad_per_s)
    _, t_dry = timed(lambda: dryrun_multichip(DRYRUN_SHARDS, device=str(dev)))
    log(f"  entry.dryrun_multichip({DRYRUN_SHARDS}, device={str(dev)!r}) ran to its end in "
        f"{t_dry:.3f} s")
    return entries


# -- phase 12: the bench entry points -------------------------------------------------


def heavy_shape(name: str, advice_cols: int | None = None):
    """(rows, advice columns, proof bytes) of a reference run's fixture in
    `params_fixtures/`: its structural fields only."""
    with open(os.path.join(ROOT, "params_fixtures", name)) as fh:
        fx = json.load(fh)
    return fx["rows"], fx.get("advice_cols", advice_cols), fx["proof_bytes"]


def fresh_dir(name: str) -> str:
    path = os.path.join(ROOT, "build", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def check_heavy(label: str, out: dict, artifacts, shape) -> None:
    """A k=17 bench's shape, verdict and a tampered copy; prints its times."""
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    pk, srs, _, proof = artifacts
    got = (out["rows"], out["advice_cols"], out["proof_bytes"])
    require(got == shape, f"{label}: rows, advice columns and proof bytes {got}, want {shape}")
    require(out["verified"], f"{label}: the proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify_proof(pk.vk, srs, bytes(bad)), f"{label}: a tampered proof verifies")
    log(f"  {label}: {out['rows']} rows, {out['advice_cols']} advice columns, "
        f"{out['proof_bytes']} bytes, verified, a tampered copy rejected; synthesis "
        f"{out['synth_s']:.4f} s, keygen {out['keygen_s']:.4f} s, cold proof "
        f"{out['proof_cold_s']:.4f} s, warm proof {out['proof_s']:.4f} s, verify "
        f"{out['verify_s']:.4f} s; peak device memory {out['peak_device_bytes'] / 2**30:.3f} GiB")


def counted_run(fn):
    """fn() with every launch, MSM call and bucket pass counted and the
    loop kernels' and K1's inputs captured; returns (fn(), counts, loop
    captures, K1 capture, MSM calls, bucket passes)."""
    import torch

    from paillier_halo2_tpu_torch.ff import mulmod
    from paillier_halo2_tpu_torch.msm import pippenger
    from paillier_halo2_tpu_torch.plonk import kzg

    torch.cuda.synchronize()
    zero_counts()
    with (LoopCaptures() as cap, CaptureLargest(mulmod, "mont_mul") as k1_cap,
          CountCalls(kzg, "msm_packed_multi") as msm_calls,
          CountCalls(pippenger, "_signed_keys") as passes):
        out = fn()
    return out, read_counts(), cap, k1_cap, msm_calls.seen, passes.seen


def check_prover_launches(label: str, counts: dict, msm_calls: int, passes: int,
                          combs: int) -> None:
    loops = ("bucket_loop_lazy", "merge_lazy", "window_sums")
    log(f"  launches over {label}: {counts}; {msm_calls} MSM calls in {passes} bucket passes")
    require(msm_calls > 0 and all(counts[name] == passes for name in loops),
            f"{label} did not launch each loop kernel once per bucket pass")
    require(all(counts[name] == 0 for name in
                ("g1_madd", "padd_mixed_packed_lazy", "padd_lazy", "g1_jadd")),
            f"{label} launched a K3, K5, K6 or K2 step")
    require(counts["fixed_base_comb"] == combs, f"{label}: {counts['fixed_base_comb']} comb "
            f"launches, want {combs}")
    require(counts["mont_mul"] > 0, f"{label} launched no K1")


class CaptureWidestAdd(CaptureCall):
    """While active, keeps the arguments of the `ff.field.add` call with the
    widest output, as the caller laid them out (views kept, not copied)."""

    def __init__(self):
        from paillier_halo2_tpu_torch.ff import field

        super().__init__(field, "add", -1)
        self.lanes = 0

    def __enter__(self):
        fn = self.orig = self.module.add

        def wrapped(spec, a, b):
            out = fn(spec, a, b)
            if out.numel() // 8 > self.lanes:
                self.args, self.lanes = (spec, a, b), out.numel() // 8
            self.seen += 1
            return out

        self.module.add = wrapped
        return self


def check_addsub_widest(cap, where: str) -> dict:
    """The field add kernel on the widest operands a run gave it, against its
    plain version."""
    import torch

    from paillier_halo2_tpu_torch.ff import field as f

    spec, a, b = cap.args
    out, ref = f.add(spec, a, b), f.add_plain(spec, a, b)
    torch.cuda.synchronize()
    require(torch.equal(out, ref), f"the field add differs from its plain version on {where}")
    # bytes: each distinct element of a and b read once (a broadcast operand
    # holds fewer than the output's lanes), the output written once
    distinct = [math.prod(n for n, st in zip(t.shape[1:], t.stride()[1:]) if st) for t in (a, b)]
    entry = {"max_abs_err": max_abs_err([out], [ref]), "ops": 0,
             "bytes": 32 * (cap.lanes + sum(distinct)),
             **addsub_timing(lambda: f.add(spec, a, b), lambda: f.add_plain(spec, a, b),
                             cap.lanes)}
    log(f"  field add on {where} ({tuple(a.shape)} + {tuple(b.shape)}, strides {a.stride()}, "
        f"{b.stride()}; {cap.lanes} lanes): equal to its plain version; kernel {entry['ms']} ms "
        f"per call ({entry['device_ms']} ms on the device), plain {entry['plain_ms']} ms")
    return entry


def check_k1_widest(k1_cap, where: str) -> dict:
    """K1 on the widest operands a run gave it, against its plain version."""
    import torch

    from paillier_halo2_tpu_torch.ff import mulmod

    spec, a, b = k1_cap.args
    out, ref = mulmod.mont_mul(spec, a, b), mulmod.mont_mul_plain(spec, a, b)
    torch.cuda.synchronize()
    require(torch.equal(out, ref), f"mont_mul differs from its plain version on {where}")
    entry = {"max_abs_err": max_abs_err([out], [ref]), "lanes": a.shape[1], "double_lanes": 0,
             "ms": cuda_ms(lambda: mulmod.mont_mul(spec, a, b), 20),
             "plain_ms": cuda_ms(lambda: mulmod.mont_mul_plain(spec, a, b), 3),
             "device_ms": device_ms(lambda: mulmod.mont_mul(spec, a, b), 10, "mont_mul_kernel")}
    log(f"  K1 on {where} ({a.shape[1]} lanes): equal to its plain version; kernel "
        f"{entry['ms']} ms per call ({entry['device_ms']} ms on the device), plain "
        f"{entry['plain_ms']} ms")
    return entry


def run_bench_subprocess(key_dir: str, params_dir: str) -> dict:
    """`benches.bench` as a user runs it, in a process of its own; every
    phase's line printed, the last with `msm_valid` and a verified proof."""
    cmd = [sys.executable, "-m", "paillier_halo2_tpu_torch.benches.bench", "--budget-s",
           str(BENCH_BUDGET_S), "--key-dir", key_dir, "--params-dir", params_dir]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_BUDGET_S + 120)
    wall = time.monotonic() - t0
    for line in proc.stderr.splitlines():
        log(f"    | {line}")
    require(proc.returncode == 0, f"benches.bench exited {proc.returncode}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    phases = [x["last_phase_done"] for x in lines]
    require(phases == BENCH_PHASES, f"benches.bench printed the phases {phases}, want {BENCH_PHASES}")
    last = lines[-1]
    log(f"  benches.bench ({wall:.1f} s): {json.dumps(last)}")
    require(last.get("msm_valid") is True, "benches.bench: the MSM is not valid")
    require(last.get("proof_verified") is True, "benches.bench: the proof does not verify")
    return last


def run_bench_phase(dev, imad_per_s: float) -> list:
    """Phase 12; returns the kernels-line entries of (a)'s run."""
    import torch

    from paillier_halo2_tpu_torch.benches import (
        bench_add,
        bench_batch,
        bench_bigenc,
        bench_scaling,
        profile_proof,
    )
    from paillier_halo2_tpu_torch.mesh.sharding import make_mesh, make_mesh_2d
    from paillier_halo2_tpu_torch.plonk.prover import create_proof

    device = str(dev)
    params_17 = fresh_dir("chip_smoke_params_k17")  # (a) makes its SRS on the card
    # (a) BASELINE config 4: B=16 encryptions at k=17
    (out, artifacts), counts, cap, k1_cap, msm_calls, passes = counted_run(
        lambda: bench_batch.run(BATCH_B, BATCH_K, BATCH_K - 1, BATCH_ENC, device,
                                params_dir=params_17))
    log(f"  (a) bench_batch {BATCH_B} {BATCH_K} {BATCH_K - 1} {BATCH_ENC}: "
        f"{out['synth_workers']} pool workers")
    check_heavy(f"B={BATCH_B} k={BATCH_K}", out, artifacts,
                heavy_shape("batch16_k17.json", BATCH_ADVICE_COLS))
    require(out["synth_workers"] > 1, "the batch was synthesized serially, not by the pool")
    check_prover_launches("(a)'s SRS, keygen and proofs", counts, msm_calls, passes, 1)
    names = ("bucket_loop_lazy", "merge_lazy", "window_sums")
    results = check_loop_kernels(cap.captured(*names), "(a)'s first MSM call", imad_per_s)
    # the comb at 2^17 against its 32 K3 step launches (its plain version
    # takes 8x phase 5's 2^14 seconds)
    check_loop_kernels(cap.captured("fixed_base_comb"), "(a)'s k=17 SRS", imad_per_s, "steps")
    results["mont_mul"] = check_k1_widest(k1_cap, "(a)'s widest operands")
    entries = [kernel_entry(name, results[name], counts[name],
                            f"phase 12 (a), bench_batch B={BATCH_B} k={BATCH_K}", imad_per_s)
               for name in ("mont_mul", *names)]
    pk, _, table, _ = artifacts
    log(f"    profile of a third proof: "
        f"{profile_call(lambda: create_proof(pk, table), out['proof_s'])}")
    del artifacts, pk, table, cap, k1_cap
    torch.cuda.empty_cache()

    # (b) the 512-bit encryption at k=17, on (a)'s SRS
    (out, artifacts), counts, _, _, msm_calls, passes = counted_run(
        lambda: bench_bigenc.run(BIGENC_ENC, BIGENC_K, device, params_dir=params_17))
    check_heavy(f"{BIGENC_ENC}-bit k={BIGENC_K}", out, artifacts, heavy_shape("bigenc512_k17.json"))
    check_prover_launches("(b)'s keygen and proofs", counts, msm_calls, passes, 0)
    log(f"  (b) warm proof's transfers: h2d {out['h2d']}, d2h {out['d2h']}")
    del artifacts
    torch.cuda.empty_cache()

    # (c) benches.bench in a process of its own
    bench_params = fresh_dir("chip_smoke_bench_params")
    run_bench_subprocess(fresh_dir("chip_smoke_bench_keys"), bench_params)

    # (d) the scaling sweep at 2^20 on one card, on (c)'s SRS: each sharded
    # call reduces its shards in one K2 launch a tree level
    meshes = [make_mesh(1 << i, device) for i in range(SCALING_SHARDS.bit_length())]
    meshes.append(make_mesh_2d(2, SCALING_SHARDS // 2, device))
    t0 = time.monotonic()
    out, counts, *_ = counted_run(
        lambda: bench_scaling.run(SCALING_LOG2, device, SCALING_SHARDS, params_dir=bench_params))
    require(out["all_equal"] and len(out["times_s"]) == len(meshes),
            "bench_scaling did not run every point")
    levels, bucket_loops = sum(tree_levels(m) for m in meshes), 1 + sum(m.size for m in meshes)
    require(counts["g1_jadd"] == levels and counts["bucket_loop_lazy"] == bucket_loops
            and counts["window_sums"] == len(meshes) + 1,
            f"bench_scaling's launches {counts}: want {levels} K2 tree levels, {bucket_loops} "
            f"bucket loops and {len(meshes) + 1} window sums")
    log(f"  (d) bench_scaling 2^{SCALING_LOG2} ({time.monotonic() - t0:.1f} s): every point "
        f"equals the unsharded MSM; {levels} K2 tree-level launches, {bucket_loops} bucket "
        f"loops; {json.dumps(out)}")

    # (e) the add circuit at k=14, twice: the second run loads the first's key
    add_keys = fresh_dir("chip_smoke_add_keys")
    params_14 = fresh_dir("chip_smoke_params_k14")
    runs = [bench_add.run(MAIN_K, device, key_dir=add_keys, params_dir=params_14)[0]
            for _ in range(2)]
    for i, r in enumerate(runs):
        got = (r["rows"], r["advice_cols"], r["proof_bytes"])
        require(got == heavy_shape("bench_add_k14.json") and r["verified"],
                f"bench_add run {i + 1}: {got}, verified {r['verified']}")
        log(f"  (e) bench_add run {i + 1}: {json.dumps(r)}")
    require(not runs[0]["keygen_cached"] and runs[1]["keygen_cached"],
            "bench_add's second run did not load the key its first run saved")

    # (f) the profile of the k=14 proof, the last warm proof traced
    profile_dir = fresh_dir("chip_smoke_profile")
    out = profile_proof.run(MAIN_K, PROFILE_REPS, device, profile_dir=profile_dir,
                            params_dir=params_14)
    require(out["verified"] and len(out["warm"]) == PROFILE_REPS
            and all(w["marks"] for w in out["warm"]), "profile_proof did not report its marks")
    traces = [os.path.join(d, f) for d, _, fs in os.walk(profile_dir) for f in fs]
    require(len(traces) == 1, f"profile_proof wrote {len(traces)} traces, want 1")
    warm = ", ".join(f"{w['proof_s']:.4f} s (h2d {w['h2d']}, d2h {w['d2h']})" for w in out["warm"])
    log(f"  (f) profile_proof k={MAIN_K}: keygen {out['keygen_s']:.4f} s, cold "
        f"{out['proof_cold_s']:.4f} s, warm {warm}; traces of "
        f"{[os.path.getsize(t) for t in traces]} bytes")
    return entries


# -- phase 13: the prover's self-checks, profile_chip ------------------------------------


def run_checks_phase(dev, params_dir: str, srs_generated_here: bool, imad_per_s: float) -> list:
    """Phase 13; returns the kernels-line entries of (a)'s and (b)'s run."""
    import torch

    from paillier_halo2_tpu_torch.benches import profile_chip
    from paillier_halo2_tpu_torch.harness.circuits import paillier_enc_add_test, paillier_enc_test
    from paillier_halo2_tpu_torch.plonk.keygen import keygen
    from paillier_halo2_tpu_torch.plonk.prover import CHECK_LEVELS, create_proof
    from paillier_halo2_tpu_torch.plonk.srs import read_or_create_srs
    from paillier_halo2_tpu_torch.plonk.verifier import verify_proof

    if srs_generated_here:
        shutil.rmtree(params_dir, ignore_errors=True)

    def synth(circuit, inp):
        from paillier_halo2_tpu_torch.gadgets.context import Context
        from paillier_halo2_tpu_torch.gadgets.range import RangeChip

        ctx = Context()
        circuit(ctx, RangeChip(ctx, MAIN_LOOKUP_BITS), inp)
        return ctx.finalize()

    def checked_proofs():
        srs = read_or_create_srs(MAIN_K, device=dev, params_dir=params_dir)
        # (a) the main path's circuit at every check level
        table = synth(paillier_enc_test, main_input())
        pk = keygen(table, MAIN_K, MAIN_LOOKUP_BITS, srs)
        proofs, secs = set(), {level: [] for level in CHECK_LEVELS}
        for _ in range(PHASE13_ROUNDS):  # the levels in turns: a proof's time varies
            for level in CHECK_LEVELS[::-1]:
                proof, t = timed(lambda: create_proof(pk, table, PHASE13_BLIND, checks=level))
                proofs.add(proof)
                secs[level].append(t)
        require(len(proofs) == 1, "the k=14 proofs differ between the check levels")
        (proof,) = proofs
        ok, t_verify = timed(lambda: verify_proof(pk.vk, srs, proof))
        require(ok, "the k=14 self-checked proof does not verify")
        log(f"  (a) k={MAIN_K} ENC={MAIN_ENC}, one key and seed: proofs byte-identical at every "
            f"level ({len(proof)} bytes, SHA-256 {hashlib.sha256(proof).hexdigest()}) and "
            f"verified ({t_verify:.4f} s); seconds in "
            f"{PHASE13_ROUNDS} rounds: " + ", ".join(
                f"checks={level!r} " + " ".join(f"{t:.4f}" for t in secs[level])
                for level in CHECK_LEVELS[::-1]))
        # (b) the add circuit under GWC
        table = synth(paillier_enc_add_test, add_input())
        pk = keygen(table, MAIN_K, MAIN_LOOKUP_BITS, srs, multiopen="gwc")
        heavy, t_heavy = timed(lambda: create_proof(pk, table, PHASE13_BLIND, checks="all"))
        plain, t_plain = timed(lambda: create_proof(pk, table, PHASE13_BLIND))
        require(heavy == plain, "the GWC add proof differs between checks='all' and 'closing'")
        ok, t_verify = timed(lambda: verify_proof(pk.vk, srs, heavy, selfcheck=True))
        require(ok, "the GWC add proof does not verify opening by opening")
        log(f"  (b) add circuit, k={MAIN_K}, GWC: checks='all' {t_heavy:.4f} s, 'closing' "
            f"{t_plain:.4f} s, equal ({len(heavy)} bytes, SHA-256 "
            f"{hashlib.sha256(heavy).hexdigest()}); verify_proof(selfcheck=True) "
            f"{t_verify:.4f} s, every opening ok")

    with CaptureWidestAdd() as add_cap:
        _, counts, cap, k1_cap, msm_calls, passes = counted_run(checked_proofs)
    check_prover_launches("(a) and (b)", counts, msm_calls, passes, int(srs_generated_here))
    require(counts["copied"] == 0, "(a) and (b) copied an operand of the field add/sub")
    names = ["bucket_loop_lazy", "merge_lazy", "window_sums",
             *(["fixed_base_comb"] if srs_generated_here else [])]
    results = check_loop_kernels(cap.captured(*names), "(a)'s first MSM call", imad_per_s)
    results["mont_mul"] = check_k1_widest(k1_cap, "(a)'s and (b)'s widest operands")
    results["field_addsub"] = check_addsub_widest(add_cap, "(a)'s and (b)'s widest operands")
    entries = [kernel_entry(name, results[name], counts[name],
                            f"phase 13 (a) and (b), self-checked proofs at k={MAIN_K}", imad_per_s)
               for name in ("mont_mul", "field_addsub", *names)]
    del cap, k1_cap, add_cap
    torch.cuda.empty_cache()

    # (c) profile_chip: every phase, the MSM on phase 12's SRS
    bench_params = os.path.join(ROOT, "build", "chip_smoke_bench_params")
    os.makedirs(bench_params, exist_ok=True)
    out, t_prof = timed(lambda: profile_chip.run(profile_chip.PHASES, str(dev), PROFILE_MSM_LOG2,
                                                 params_dir=bench_params))
    msm = out["msm"]
    require(msm["valid"] and set(out) >= set(profile_chip.PHASES),
            "profile_chip did not run every phase, or its MSM is not the fixture's")
    log(f"  (c) profile_chip ({t_prof:.1f} s) on {out['card']}: MSM 2^{PROFILE_MSM_LOG2} signed whole call "
        f"{msm['full_ms']:.4f} ms; " + ", ".join(f"{k} {v:.4f} ms ({100 * msm['shares'][k]:.1f} %)"
                                                 for k, v in msm["parts_ms"].items())
        + f"; gap {msm['gap_ms']:.4f} ms; hbm {[round(x['gbps'], 1) for x in out['hbm']]} GB/s; "
        f"K1 {out['mulmod']['mont_mul']['ms']:.4f} ms, K7 {out['mulmod']['mont_mul_lazy']['ms']:.4f}"
        f" ms at 2^20; K4 {out['padd']['madd_packed_nodouble']['m_adds_per_s']:.1f}, K2 "
        f"{out['padd']['jadd']['m_adds_per_s']:.1f} M adds/s at 2^16")
    return entries


def bound(name: str, entry: dict, imad_per_s: float):
    """(bound_ms, bound_by) of one timed call of `name` (see WORK), or of
    the work an entry counted itself (`ops`, `bytes`)."""
    if "ops" in entry:
        ops, nbytes = entry["ops"], entry["bytes"]
    else:
        products, dbl_products, per_lane = WORK[name]
        ops = IMAD_PER_PRODUCT * (products * entry["lanes"] + dbl_products * entry["double_lanes"])
        nbytes = per_lane * entry["lanes"]
    t_ops, t_bytes = ops / imad_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_entry(name: str, r: dict, launches, where: str, imad_per_s: float) -> dict:
    """One kernel's object on the kernels line."""
    source, replaces = KERNELS[name]
    bound_ms, bound_by = bound(name, r, imad_per_s)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": r["device_ms"], "launches_counted_on": where}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,10,11,12,13",
                    help="comma-separated phases to run")
    phases = {int(p) for p in ap.parse_args().phases.split(",")}

    t_start = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's card path cannot run here")
    sys.path.insert(0, ROOT)
    from paillier_halo2_tpu_torch.poly import ops
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
    ptxas_report(os.path.join(kernels.BUILD_DIR, "ptxas.log"))
    product_probe()

    results: dict = {}
    launches: dict = {}
    if 2 in phases:
        log("[2] kernels against their plain versions on the card")
        check_mont_mul(dev, results)
        check_points(dev, results)
        check_mont_mul_lazy(dev, results)
        check_lazy_points(dev, results)
        check_field_addsub(dev, results)
    if 3 in phases:
        log("[3] MSM 2^14, signed and unsigned routes")
        unsigned = check_msm(dev, results, imad_per_s)
        for name in ("g1_madd_packed", "bucket_loop", "g1_jadd"):
            launches[name] = unsigned[name]
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
        ops.reset_ntt_routes()
        torch.cuda.reset_peak_memory_stats(dev)
        with LoopCaptures() as cap:
            stats = run_main_path(dev, params_dir)
        main_counts = read_counts()
        log(f"  NTT routes over the main path: {ops.NTT_ROUTES}")
        require(ops.NTT_ROUTES["native"] == 0 and ops.NTT_ROUTES["torch"] > 0,
                "a transform of the main path did not run on the card")
        for line in stats.pretty().splitlines():
            log("  " + line)
        log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        log(f"  launches during the main path: {main_counts}")
        require(stats.verified, "main-path proof did not verify")
        require(main_counts["fixed_base_comb"] == 1, "the main path's SRS did not run one comb launch")
        require(main_counts["bucket_loop_lazy"] == main_counts["merge_lazy"]
                == main_counts["window_sums"] > 0,
                "the main path's MSM calls did not launch each loop kernel once")
        require(all(main_counts[name] == 0 for name in
                    ("g1_madd", "padd_mixed_packed_lazy", "padd_lazy", "g1_jadd")),
                "the main path launched a K3, K5, K6 or K2 step")
        require(main_counts["copied"] == 0,
                "the main path copied an operand of the field add/sub kernel")
        for name in ("mont_mul", "g1_madd", "padd_lazy", "window_sums", "bucket_loop_lazy",
                     "padd_mixed_packed_lazy", "merge_lazy", "fixed_base_comb", "field_addsub"):
            launches[name] = main_counts[name]
        results.update(check_loop_kernels(
            cap.captured("fixed_base_comb", "bucket_loop_lazy", "merge_lazy", "window_sums"),
            "the main path's SRS and first MSM call", imad_per_s))
        check_srs_cache(dev, params_dir)
    if 6 in phases:
        log("[6] MSM 2^20 entry, signed and unsigned routes")
        run_msm_entry(dev, imad_per_s)
    if 7 in phases:
        log("[7] lazy-mulmod entry, Fr, 2^20 lanes")
        launches["mont_mul_lazy"] = run_mulmod_lazy(dev)["mont_mul_lazy"]
    mock_k1 = None
    if 8 in phases:
        log(f"[8] MockProver: the reference's geometries, {BIG_ENC}-bit one-shot and chunked, tampered")
        mock_k1 = run_mock_phase(dev)
        require(mock_k1["launches"] > 0, "the MockProver launched no K1")
    if 9 in phases:
        log(f"[9] BASELINE.json config 1: the {CONFIG1_ENC}-bit MockProver")
        run_config1(dev)
    key_entries = []
    if 10 in phases:
        log("[10] GWC and instance columns at K=10; keys saved and loaded at k=14")
        t10 = time.monotonic()
        check_slice_fixture(dev, "slice_enc_k10_gwc.json", "gwc")
        check_instance_fixture(dev)
        params_dir = os.path.join(ROOT, "build", "chip_smoke_params")
        if 5 not in phases:
            shutil.rmtree(params_dir, ignore_errors=True)  # the SRS is generated here
        key_entries = run_key_phase(dev, params_dir, 5 not in phases, imad_per_s)
        log(f"  phase 10 took {time.monotonic() - t10:.1f} s")
    mesh_entries = []
    if 11 in phases:
        log("[11] the mesh and the distributed prover: four-step NTT, sharded MSM, "
            f"K=10 and k={MAIN_K} proofs, dryrun_multichip({DRYRUN_SHARDS})")
        t11 = time.monotonic()
        params_dir = os.path.join(ROOT, "build", "chip_smoke_params")
        mesh_entries = run_mesh_phase(dev, params_dir, not {5, 10} & phases, imad_per_s)
        log(f"  phase 11 took {time.monotonic() - t11:.1f} s")
    bench_entries = []
    if 12 in phases:
        log(f"[12] the bench entries: bench_batch {BATCH_B} {BATCH_K}, bench_bigenc {BIGENC_ENC} "
            f"{BIGENC_K}, bench, bench_scaling 2^{SCALING_LOG2}, bench_add {MAIN_K} (twice), "
            f"profile_proof {MAIN_K} {PROFILE_REPS}")
        t12 = time.monotonic()
        bench_entries = run_bench_phase(dev, imad_per_s)
        log(f"  phase 12 took {time.monotonic() - t12:.1f} s")
    check_entries = []
    if 13 in phases:
        log(f"[13] self-checked proofs at k={MAIN_K} (SHPLONK, GWC), profile_chip")
        t13 = time.monotonic()
        ops.reset_ntt_routes()
        check_entries = run_checks_phase(dev, os.path.join(ROOT, "build", "chip_smoke_params"),
                                         5 not in phases, imad_per_s)
        log(f"  NTT routes over phase 13: {ops.NTT_ROUTES}")
        require(ops.NTT_ROUTES["native"] == 0, "a transform of phase 13 went to the host")
        log(f"  phase 13 took {time.monotonic() - t13:.1f} s")
    if {3, 5, 7} <= phases:
        for name in KERNELS:
            if name not in OFF_PATH:
                require(launches[name] > 0, f"kernel {name} was not launched on its path")

    log(f"phases {sorted(phases)} passed in {time.monotonic() - t_start:.1f} s")
    kernels_line = []
    if {2, 3} <= phases:
        for name in KERNELS:
            kernels_line.append(kernel_entry(name, results[name], launches.get(name),
                                             LAUNCH_PATH.get(name, "phase 5, the main path"),
                                             imad_per_s))
    if mock_k1 is not None:
        kernels_line.append(kernel_entry("mont_mul", mock_k1, mock_k1["launches"],
                                         "phase 8, the MockProver", imad_per_s))
    kernels_line.extend(key_entries)
    kernels_line.extend(mesh_entries)
    kernels_line.extend(bench_entries)
    kernels_line.extend(check_entries)
    if kernels_line:
        print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
