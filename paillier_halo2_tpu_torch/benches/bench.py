"""Round benchmark: MSM throughput at 2^20 points, Montgomery-product rates
and proofs/s on the reference bench geometry, on one device.

Counterpart of `bench.py`:

    python -m paillier_halo2_tpu_torch.benches.bench [--device cpu] [--budget-s 900]
        [--msm-log2 20] [--mulmod-log2 20] [--proof-k 14] [--proof-enc 128]
        [--proof-limb 64] [--skip-proof] [--force-keygen] [--key-dir DIR]
        [--params-dir DIR]

Phases, each followed by one JSON line on stdout with everything measured so
far and `bench.py`'s keys (the last line is the result):

- `mulmod`: ten chained Montgomery products over Fr (K1 on the card) at
  2^20 lanes of `bench.py`'s digits; the rate beside two ceilings, the
  device's measured copy rate and the H100's data-sheet 3.35 TB/s, each
  over the 96 bytes a product moves in the port's (8, N) int32 layout;
- `mulmod_lazy`: the same with the lazy product (K7) on `bench.py`'s
  lazy digits;
- `msm`: the MSM over the seed-b"" SRS with `bench.py`'s scalars, first
  and warm, validated against `params_fixtures/bench_msm_expected_{k}.json`
  (or, for a size without a fixture, the host's MSM) as `msm_valid`;
- `keygen`, `proof_cold`, `final`: the ENC=128/LIMB=64 encryption circuit
  at k=14 (upstream src/bench.rs:161-179), inputs from `random.Random(14)`,
  its key loaded from `--key-dir` when the table's fingerprint matches,
  then a cold and a warm proof and verify.

Each phase has a deadline carved out of `--budget-s` (as `bench.py`'s
SIGALRM guards, `bench.py:62-83`), checked between phases and between the
steps of the MSM and proof phases; a native call is never interrupted, and
no result is reported whose check did not run. On the CPU no device
bandwidth is measured: those keys are null. Not ported: `vs_baseline`
(against the TPU rounds' `BENCH_r0*.json`) and the CPU-proxy ratio.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time

H100_SPEC_GBPS = 3350.0  # NVIDIA H100 SXM data sheet, HBM3
BYTES_PER_PRODUCT = 3 * 32  # two (8,) int32 limb operands read, one written


class PhaseTimeout(Exception):
    pass


class Bench:
    """The run's budget and the result line it prints after each phase."""

    def __init__(self, budget_s: float):
        self.t_start = time.monotonic()
        self.budget_s = budget_s
        self.msm_points_per_s = 0.0
        self.extras: dict = {}

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t_start)

    def deadline(self, seconds: float, label: str):
        """A `check(where)` that raises PhaseTimeout once `seconds` have
        passed or the budget less a 30 s margin for the last line is
        spent."""
        seconds = min(seconds, self.remaining() - 30)
        if seconds <= 0:
            raise PhaseTimeout(f"{label}: no budget left")
        end = time.monotonic() + seconds

        def check(where: str) -> None:
            if time.monotonic() > end:
                raise PhaseTimeout(f"{label}: deadline passed before {where}")

        return check

    def emit(self, phase_done: str) -> dict:
        self.extras["last_phase_done"] = phase_done
        line = {"metric": "msm_points_per_s_2^20", "value": self.msm_points_per_s,
                "unit": "points/s/chip", **self.extras}
        print(json.dumps(line), flush=True)
        return line


def _copy_gbps(device) -> float:
    """The device's read+write copy rate: five `x + 1` passes over 256 MB."""
    import torch

    from . import sync

    x = torch.arange(64 << 20, dtype=torch.int32, device=device)
    y = x + 1
    sync(device)
    t0 = time.monotonic()
    reps = 5
    for _ in range(reps):
        y = y + 1
    sync(device)
    return 2 * x.numel() * 4 * reps / (time.monotonic() - t0) / 1e9


def _rate_keys(prefix: str, per_s: float, copy_gbps: float | None) -> dict:
    """The rate and its ceilings (`bench.py`'s keys); the ceilings are null
    where no device bandwidth was measured."""
    keys = {f"{prefix}_per_s": per_s,
            f"{prefix}_gbps_effective": per_s * BYTES_PER_PRODUCT / 1e9,
            f"{prefix}_pct_of_hbm_ceiling": None, f"{prefix}_pct_of_spec_bw": None}
    if copy_gbps is not None:
        keys[f"{prefix}_pct_of_hbm_ceiling"] = 100 * per_s * BYTES_PER_PRODUCT / (copy_gbps * 1e9)
        keys[f"{prefix}_pct_of_spec_bw"] = 100 * per_s * BYTES_PER_PRODUCT / (H100_SPEC_GBPS * 1e9)
    return keys


def _chain_rate(mul, a, b, device, check) -> float:
    """Products per second of ten chained products r = mul(r, b)."""
    from . import sync

    r = mul(a, b)
    sync(device)
    reps = 10
    t0 = time.monotonic()
    for i in range(reps):
        check(f"product {i}")
        r = mul(r, b)
    sync(device)
    return a.shape[1] * reps / (time.monotonic() - t0)


def bench_scalars(k: int, device):
    """`bench.py`'s scalar stream (`np.random.default_rng(1)`, four 63-bit
    draws a scalar, reduced mod r): (host ints, (8, 2^k) limbs)."""
    import numpy as np

    from ..ec import host as ech
    from ..ff import field as f

    hi = np.random.default_rng(1).integers(0, 2**63, (4, 1 << k), dtype=np.int64)
    scalars = [(int(x) | int(y) << 63 | int(z) << 126 | int(w) << 189) % ech.R
               for x, y, z, w in zip(*hi)]
    return scalars, f.pack_ints(scalars, device)


def msm_expected(k: int, srs, scalars):
    """The committed `params_fixtures/bench_msm_expected_{k}.json`, or the
    host's MSM (native engine) for a size without one."""
    from ..ec import host as ech
    from . import REPO, log

    path = os.path.join(REPO, "params_fixtures", f"bench_msm_expected_{k}.json")
    if os.path.exists(path):
        with open(path) as fh:
            ex, ey = json.load(fh)
        return (int(ex, 16), int(ey, 16)) if ex else None
    log(f"no fixture for 2^{k}; computing the host's MSM")
    return ech.g1_msm(srs.g1_points(), scalars)


def run(device="cuda", budget_s: float = 900.0, msm_log2: int = 20, mulmod_log2: int = 20,
        proof_k: int = 14, proof_enc: int = 128, proof_limb: int = 64, skip_proof: bool = False,
        force_keygen: bool = False, key_dir: str | None = None,
        params_dir: str | None = None) -> dict:
    import numpy as np
    import torch

    from ..ff import field as f
    from ..ff import lazy_mont, mulmod
    from ..harness.circuits import paillier_enc_test
    from ..msm.pippenger import msm_packed
    from ..plonk.srs import read_or_create_srs
    from . import (
        KEY_DIR,
        cached_keygen,
        check_device,
        enc_input,
        log,
        prove_verify,
        synth,
        timed,
    )

    bench = Bench(budget_s)
    ex = bench.extras
    name = check_device(device)
    on_card = torch.device(device).type == "cuda"
    log(f"device: {name}")
    bench.emit("start")

    copy_gbps = None
    if on_card:
        try:
            bench.deadline(120, "hbm_bw")("the copy")
            copy_gbps = _copy_gbps(device)
            log(f"copy rate: {copy_gbps:.1f} GB/s (read+write, measured); H100 data sheet "
                f"{H100_SPEC_GBPS:.0f} GB/s")
        except PhaseTimeout as e:
            log(f"** phase timed out: {e}")
            ex["hbm_bw_timeout"] = True
    ex["hbm_copy_gbps_measured"] = copy_gbps

    n = 1 << mulmod_log2
    rng = np.random.default_rng(1)
    digits = [rng.integers(0, 255, (32, n)).astype(np.uint32) for _ in range(2)]
    for d in digits:
        d[31] &= 0x1F
    try:
        check = bench.deadline(300, "mulmod")
        a, b = (f.from_ref_digits(d, device) for d in digits)
        per_s = _chain_rate(lambda x, y: mulmod.mont_mul(f.FR, x, y), a, b, device, check)
        ex.update(_rate_keys("mulmod", per_s, copy_gbps))
        log(f"mulmod: {per_s / 1e6:.3f} M/s ({ex['mulmod_pct_of_hbm_ceiling']} % of the measured "
            f"copy rate's ceiling, {ex['mulmod_pct_of_spec_bw']} % of the H100 data sheet's)")
    except PhaseTimeout as e:
        log(f"** phase timed out: {e}")
        ex["mulmod_timeout"] = True
    bench.emit("mulmod")

    try:
        check = bench.deadline(240, "mulmod_lazy")
        rng = np.random.default_rng(1)
        al, bl = (f.from_lazy_digits(f.FR, rng.integers(0, 255, (32, n)).astype(np.int16), device)
                  for _ in range(2))
        check("the lazy chain")
        per_s = _chain_rate(lambda x, y: lazy_mont.mont_mul_lazy(f.FR, x, y), al, bl, device,
                            check)
        ex.update(_rate_keys("mulmod_lazy", per_s, copy_gbps))
        log(f"lazy mulmod: {per_s / 1e6:.3f} M/s")
    except PhaseTimeout as e:
        log(f"** phase timed out: {e}")
        ex["mulmod_lazy_timeout"] = True
    bench.emit("mulmod_lazy")

    try:
        check = bench.deadline(600, "msm")
        n_pts = 1 << msm_log2
        srs, t_srs = timed(lambda: read_or_create_srs(msm_log2, device=device,
                                                      params_dir=params_dir), device)
        log(f"srs k={msm_log2} ready in {t_srs:.3f}s")
        scalars, sd = bench_scalars(msm_log2, device)
        check("the first MSM")
        args = (srs.g1_px, srs.g1_py, srs.g1_inf, sd)
        _, t_first = timed(lambda: msm_packed(*args), device)
        check("the warm MSM")
        out, t_msm = timed(lambda: msm_packed(*args), device)
        bench.msm_points_per_s = n_pts / t_msm
        log(f"msm 2^{msm_log2}: first={t_first:.3f}s warm={t_msm:.4f}s -> "
            f"{bench.msm_points_per_s / 1e6:.3f} M points/s")
        check("the MSM's validation")
        expected = msm_expected(msm_log2, srs, scalars)
        ex["msm_valid"] = out == expected
        ex["msm_warm_s"] = t_msm
        if not ex["msm_valid"]:
            log(f"** MSM VALIDATION FAILED: got {out} want {expected}")
        del srs, sd, args
    except PhaseTimeout as e:
        log(f"** phase timed out: {e}")
        ex["msm_timeout"] = True
    bench.emit("msm")

    if not skip_proof:
        try:
            check = bench.deadline(bench.remaining() - 60, "proof")
            k, lk = proof_k, proof_k - 1
            table = synth(paillier_enc_test,
                          enc_input(random.Random(14), proof_enc, proof_limb), lk)
            log(f"proof circuit: {table.n_rows} rows, k={k}")
            srs_p = read_or_create_srs(k, device=device, params_dir=params_dir)
            check("keygen")
            path = os.path.join(key_dir or KEY_DIR, f"pk_bench_k{k}_enc{proof_enc}.npz")
            pk, t_keygen = cached_keygen(table, k, lk, srs_p, path, device, force_keygen)
            if t_keygen is None:
                ex["keygen_cached"] = True
            bench.emit("keygen")
            check("the cold proof")

            def between(step: str, so_far: dict) -> None:
                if step == "the warm proof":
                    ex.update(proof_cold_s=so_far["proof_cold_s"], keygen_s=t_keygen)
                    bench.emit("proof_cold")
                check(step)

            stats, _ = prove_verify(pk, srs_p, table, device, check=between)
            ex.update(h2d_per_proof=stats["h2d"], d2h_per_proof=stats["d2h"],
                      host_syncs_per_proof=stats["h2d"] + stats["d2h"],
                      proof_verified=stats["verified"], keygen_s=t_keygen,
                      proof_cold_s=stats["proof_cold_s"], proof_s=stats["proof_s"],
                      verify_s=stats["verify_s"], proof_bytes=stats["proof_bytes"],
                      proofs_per_sec=stats["proofs_per_sec"], proof_k=k,
                      proof_enc_bits=proof_enc)
            log(f"k={k} enc{proof_enc} proof: keygen="
                f"{'cached' if t_keygen is None else f'{t_keygen:.3f}s'} "
                f"cold={stats['proof_cold_s']:.3f}s warm={stats['proof_s']:.3f}s "
                f"verify={stats['verify_s']:.3f}s ok={stats['verified']}")
        except PhaseTimeout as e:
            log(f"** phase timed out: {e}")
            ex["proof_timeout"] = True
    return bench.emit("final")


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description="Round benchmark: mulmod, MSM and proof phases")
    ap.add_argument("--device", default=device)
    ap.add_argument("--budget-s", type=float, default=900.0, help="BENCH_BUDGET_S")
    ap.add_argument("--msm-log2", type=int, default=20, help="BENCH_MSM_LOG2")
    ap.add_argument("--mulmod-log2", type=int, default=20, help="lanes of the mulmod phases")
    ap.add_argument("--proof-k", type=int, default=14, help="BENCH_PROOF_K")
    ap.add_argument("--proof-enc", type=int, default=128)
    ap.add_argument("--proof-limb", type=int, default=64)
    ap.add_argument("--skip-proof", action="store_true", help="BENCH_SKIP_PROOF=1")
    ap.add_argument("--force-keygen", action="store_true", help="BENCH_FORCE_KEYGEN=1")
    ap.add_argument("--key-dir", default=None, help="proving-key cache (default build/bench_keys)")
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    a = ap.parse_args(argv)
    return run(a.device, a.budget_s, a.msm_log2, a.mulmod_log2, a.proof_k, a.proof_enc,
               a.proof_limb, a.skip_proof, a.force_keygen, a.key_dir, a.params_dir)


if __name__ == "__main__":
    main()
