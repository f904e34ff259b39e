"""Phase-level profile of the reference-geometry proof (ENC=128/LIMB=64,
lookup_bits = k - 1, inputs from `random.Random(14)`): keygen, one cold
and N warm proofs, each warm proof's `PhaseTimer` marks and host<->device
transfers, then verify.

Counterpart of `profile_proof.py`:

    python -m paillier_halo2_tpu_torch.benches.profile_proof [k] [warm_reps]
        [--device cpu] [--profile-dir DIR] [--trace-json PATH] [--params-dir DIR]

Defaults: k=14, 2 warm proofs. The prover's marks print as they come (the
JAX script's PAILLIER_TPU_TRACE=1); `--trace-json` (PAILLIER_TPU_TRACE_JSON)
appends them to a file as JSON; `--profile-dir` (PAILLIER_TPU_PROFILE)
writes a `torch.profiler` trace of the last warm proof under that directory
(a trace of the k=14 proof holds hundreds of MB).
"""
from __future__ import annotations

import argparse
import json
import random

ENC, LIMB, SEED = 128, 64, 14


def run(k: int = 14, reps: int = 2, device="cuda", profile_dir: str | None = None,
        trace_json: str | None = None, params_dir: str | None = None) -> dict:
    from ..harness.circuits import paillier_enc_test
    from ..plonk.keygen import keygen
    from ..plonk.prover import create_proof
    from ..plonk.srs import read_or_create_srs
    from ..plonk.verifier import verify_proof
    from ..poly import ops
    from ..utils.trace import PhaseTimer
    from . import check_device, enc_input, log, synth, timed

    name = check_device(device)
    log(f"device: {name}")
    table = synth(paillier_enc_test, enc_input(random.Random(SEED), ENC, LIMB), k - 1)
    log(f"circuit: {table.n_rows} rows, k={k}")
    srs = read_or_create_srs(k, device=device, params_dir=params_dir)
    pk, t_keygen = timed(lambda: keygen(table, k, k - 1, srs), device)
    log(f"keygen: {t_keygen:.3f}s advice={pk.vk.num_advice}")
    _, t_cold = timed(lambda: create_proof(pk, table), device)
    log(f"cold proof: {t_cold:.3f}s")
    warm = []
    for i in range(reps):
        ops.reset_transfer_counts()
        timer = PhaseTimer(f"prover, warm proof {i}", echo=True, json_path=trace_json)
        traced = profile_dir if i == reps - 1 else None
        proof, dt = timed(lambda: create_proof(pk, table, timer=timer, profile_dir=traced),
                          device)
        warm.append({"proof_s": dt, "traced": traced is not None, "h2d": ops.TRANSFER_COUNTS["h2d"],
                     "d2h": ops.TRANSFER_COUNTS["d2h"],
                     "marks": [{"phase": label, "t_total_s": total, "t_delta_s": delta}
                               for label, total, delta in timer.marks]})
        log(f"warm proof {i}: {dt:.3f}s h2d={warm[-1]['h2d']} d2h={warm[-1]['d2h']}")
    ok, t_verify = timed(lambda: verify_proof(pk.vk, srs, proof), device)
    log(f"verify: {t_verify:.3f}s ok={ok} bytes={len(proof)}")
    return {"k": k, "rows": int(table.n_rows), "advice_cols": pk.vk.num_advice,
            "keygen_s": t_keygen, "proof_cold_s": t_cold, "warm": warm, "verify_s": t_verify,
            "verified": bool(ok), "proof_bytes": len(proof), "profile_dir": profile_dir,
            "device": name}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description="Phase-level profile of the k=14 proof")
    ap.add_argument("k", nargs="?", type=int, default=14)
    ap.add_argument("warm_reps", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=device)
    ap.add_argument("--profile-dir", default=None, help="write torch.profiler traces here")
    ap.add_argument("--trace-json", default=None, help="append the marks here as JSON")
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    a = ap.parse_args(argv)
    out = run(a.k, a.warm_reps, a.device, a.profile_dir, a.trace_json, a.params_dir)
    print(json.dumps(out), flush=True)
    if not out["verified"]:
        raise RuntimeError("proof rejected")
    return out


if __name__ == "__main__":
    main()
