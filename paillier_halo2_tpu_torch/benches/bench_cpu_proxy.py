"""CPU proxy: the reference bench geometry end to end on this host's CPU,
the transforms and the commitments on the native C++ engine
(`native/bn254.cpp`, the same algorithm class as halo2's rayon NTT and
Pippenger).

Counterpart of `bench_cpu_proxy.py`:

    python -m paillier_halo2_tpu_torch.benches.bench_cpu_proxy [k]
        [--enc 128] [--limb 64] [--out PATH] [--params-dir DIR]

The ENC=128/LIMB=64 encryption circuit of `random.Random(14)`'s inputs at
k (default 14) with lookup_bits k - 1 goes through synthesis, SRS, keygen,
a cold and a warm proof and verify, always on `device="cpu"`: the NTTs on
`native.fr_ntt` (the CPU's route in `poly/ops.py`), the commitments on
`native.g1_msm_raw`. Prints one JSON line with the JAX script's keys
(`backend: "cpu+native"`) and writes it to `--out` where given; nothing
goes into `params_fixtures/`. `benches.bench --cpu-proxy-json PATH` reports
the card's proof time against it.
"""
from __future__ import annotations

import argparse
import json
import os
import random

SEED = 14


def run(k: int = 14, enc_bits: int = 128, limb_bits: int = 64, out: str | None = None,
        params_dir: str | None = None) -> dict:
    from ..harness.circuits import paillier_enc_test
    from ..plonk.keygen import keygen
    from ..plonk.prover import create_proof
    from ..plonk.srs import read_or_create_srs
    from ..plonk.verifier import verify_proof
    from ..poly import ops
    from . import enc_input, log, synth, timed

    device, lk = "cpu", k - 1
    log(f"CPU proxy: enc={enc_bits}/{limb_bits} k={k} lookup={lk}, {os.cpu_count()} CPUs, "
        "native NTT and MSM")
    table, t_synth = timed(lambda: synth(paillier_enc_test,
                                         enc_input(random.Random(SEED), enc_bits, limb_bits), lk),
                           device)
    log(f"circuit: {table.n_rows} rows, k={k} (synth {t_synth:.3f}s)")
    srs = read_or_create_srs(k, device=device, params_dir=params_dir)
    pk, t_keygen = timed(lambda: keygen(table, k, lk, srs), device)
    log(f"keygen: {t_keygen:.3f}s")
    _, t_cold = timed(lambda: create_proof(pk, table), device)
    log(f"cold proof: {t_cold:.3f}s")
    ops.reset_ntt_routes()
    proof, t_warm = timed(lambda: create_proof(pk, table), device)
    if ops.NTT_ROUTES["native"] == 0 or ops.NTT_ROUTES["torch"]:
        raise RuntimeError(f"the proxy's transforms did not all run native: {ops.NTT_ROUTES}")
    ok, t_verify = timed(lambda: verify_proof(pk.vk, srs, proof), device)
    log(f"warm proof: {t_warm:.3f}s verify {t_verify:.3f}s ok={ok}")
    line = {"backend": "cpu+native", "k": k, "enc_bits": enc_bits, "rows": int(table.n_rows),
            "keygen_s": t_keygen, "proof_cold_s": t_cold, "proof_s": t_warm,
            "verify_s": t_verify, "verified": bool(ok), "proof_bytes": len(proof),
            "proofs_per_sec": 1.0 / t_warm, "cpus": os.cpu_count()}
    print(json.dumps(line), flush=True)
    if out is not None:
        with open(out, "w") as fh:
            json.dump(line, fh)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The reference geometry on the host CPU")
    ap.add_argument("k", nargs="?", type=int, default=14)
    ap.add_argument("--enc", type=int, default=128, help="encryption bits (the reference's 128)")
    ap.add_argument("--limb", type=int, default=64, help="limb bits (the reference's 64)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    a = ap.parse_args(argv)
    line = run(a.k, a.enc, a.limb, a.out, a.params_dir)
    if not line["verified"]:
        raise RuntimeError("proof rejected")
    return line


if __name__ == "__main__":
    main()
