"""Large-encryption proving bench: ONE Paillier encryption at ENC >= 512
bits (LIMB = 64, lookup_bits = k - 1, inputs from `random.Random(512)`),
then SRS, keygen, a cold and a warm KZG proof and verify.

Counterpart of `bench_bigenc.py:29-97`:

    python -m paillier_halo2_tpu_torch.benches.bench_bigenc [enc_bits] [k]
        [--device cpu] [--params-dir DIR]

Defaults: enc_bits=512, k=17. Besides the script's keys the JSON line
carries the warm proof's host<->device transfers (`h2d`, `d2h`,
`poly.ops.TRANSFER_COUNTS`), the peak device memory and the device.
"""
from __future__ import annotations

import argparse
import json
import random

LIMB = 64
SEED = 512


def circuit_table(enc_bits: int, lookup_bits: int):
    """The script's circuit: one encryption of `random.Random(512)`'s
    inputs."""
    from ..harness.circuits import paillier_enc_test
    from . import enc_input, synth

    return synth(paillier_enc_test, enc_input(random.Random(SEED), enc_bits, LIMB), lookup_bits)


def run(enc_bits: int = 512, k: int = 17, device="cuda", params_dir: str | None = None,
        checks: str = "closing"):
    """The bench; returns (its JSON keys, (pk, srs, table, proof))."""
    from ..plonk.keygen import keygen
    from ..plonk.srs import read_or_create_srs
    from . import check_device, log, peak_device_bytes, prove_verify, reset_peak, timed

    lk = k - 1
    name = check_device(device)
    log(f"device: {name}; enc={enc_bits} k={k} lookup={lk}")
    reset_peak(device)
    table, t_synth = timed(lambda: circuit_table(enc_bits, lk), device)
    log(f"circuit: {table.n_rows} rows (synth {t_synth:.3f}s)")
    srs = read_or_create_srs(k, device=device, params_dir=params_dir)
    pk, t_keygen = timed(lambda: keygen(table, k, lk, srs), device)
    log(f"keygen: {t_keygen:.3f}s advice={pk.vk.num_advice}")
    stats, proof = prove_verify(pk, srs, table, device, checks=checks)
    out = {"enc_bits": enc_bits, "k": k, "rows": int(table.n_rows),
           "advice_cols": pk.vk.num_advice, "synth_s": t_synth, "keygen_s": t_keygen,
           **stats, "peak_device_bytes": peak_device_bytes(device), "device": name}
    return out, (pk, srs, table, proof)


def main(argv=None, device="cuda") -> dict:
    from ..plonk.prover import CHECK_LEVELS

    ap = argparse.ArgumentParser(description="Large-encryption proving bench")
    ap.add_argument("enc_bits", nargs="?", type=int, default=512)
    ap.add_argument("k", nargs="?", type=int, default=17)
    ap.add_argument("--device", default=device)
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    ap.add_argument("--checks", default="closing", choices=CHECK_LEVELS,
                    help="the prover's self-checks (PAILLIER_TPU_SELFCHECK)")
    a = ap.parse_args(argv)
    out, _ = run(a.enc_bits, a.k, a.device, a.params_dir, a.checks)
    print(json.dumps(out), flush=True)
    if not out["verified"]:
        raise RuntimeError("proof rejected")
    return out


if __name__ == "__main__":
    main()
