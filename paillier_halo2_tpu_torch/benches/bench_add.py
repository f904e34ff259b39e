"""Full-pipeline bench of the homomorphic-ADDITION circuit at the reference
bench geometry (upstream src/bench.rs:181-222: ENC=128/LIMB=64, k=14,
lookup_bits=13): synthesis, SRS, a cached or fresh key, a cold and a warm
KZG proof and verify.

Counterpart of `bench_add.py`:

    python -m paillier_halo2_tpu_torch.benches.bench_add [k]
        [--device cpu] [--key-dir DIR] [--force-keygen] [--params-dir DIR]

The inputs come from `random.Random(141)`. The proving key is cached as
`pk_add_k{k}_enc128.npz` under `--key-dir` (default `build/bench_keys/`)
and loaded when its `table_fingerprint` matches; `--force-keygen` (for
BENCH_FORCE_KEYGEN=1) always runs keygen. `keygen_s` is null and
`keygen_cached` true where the key was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import random

ENC, LIMB, SEED = 128, 64, 141


def add_input():
    from ..bignum.host import paillier_add_native
    from ..harness.circuits import PaillierAddCipherInput

    prng = random.Random(SEED)
    n = prng.getrandbits(ENC) | (1 << (ENC - 1)) | 1
    g, c1, c2 = (prng.getrandbits(ENC) for _ in range(3))
    return PaillierAddCipherInput(limb_bits=LIMB, enc_bits=ENC, n=n, g=g, c1=c1, c2=c2,
                                  res=paillier_add_native(n, c1, c2))


def run(k: int = 14, device="cuda", key_dir: str | None = None, force_keygen: bool = False,
        params_dir: str | None = None, checks: str = "closing"):
    """The bench; returns (its JSON keys, (pk, srs, table, proof))."""
    from ..harness.circuits import paillier_enc_add_test
    from ..plonk.srs import read_or_create_srs
    from . import KEY_DIR, cached_keygen, check_device, log, prove_verify, synth, timed

    lk = k - 1
    name = check_device(device)
    log(f"device: {name}; add circuit enc={ENC} k={k} lookup={lk}")
    table, t_synth = timed(lambda: synth(paillier_enc_add_test, add_input(), lk), device)
    log(f"circuit: {table.n_rows} rows (synth {t_synth:.3f}s)")
    srs = read_or_create_srs(k, device=device, params_dir=params_dir)
    path = os.path.join(key_dir or KEY_DIR, f"pk_add_k{k}_enc{ENC}.npz")
    pk, t_keygen = cached_keygen(table, k, lk, srs, path, device, force_keygen)
    stats, proof = prove_verify(pk, srs, table, device, checks=checks)
    out = {"circuit": "paillier_add", "enc_bits": ENC, "k": k, "rows": int(table.n_rows),
           "advice_cols": pk.vk.num_advice, "synth_s": t_synth, "keygen_s": t_keygen,
           "keygen_cached": t_keygen is None, **stats, "device": name}
    return out, (pk, srs, table, proof)


def main(argv=None, device="cuda") -> dict:
    from ..plonk.prover import CHECK_LEVELS

    ap = argparse.ArgumentParser(description="Addition-circuit proving bench")
    ap.add_argument("k", nargs="?", type=int, default=14)
    ap.add_argument("--device", default=device)
    ap.add_argument("--key-dir", default=None, help="proving-key cache (default build/bench_keys)")
    ap.add_argument("--force-keygen", action="store_true")
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    ap.add_argument("--checks", default="closing", choices=CHECK_LEVELS,
                    help="the prover's self-checks (PAILLIER_TPU_SELFCHECK)")
    a = ap.parse_args(argv)
    out, _ = run(a.k, a.device, a.key_dir, a.force_keygen, a.params_dir, a.checks)
    print(json.dumps(out), flush=True)
    if not out["verified"]:
        raise RuntimeError("proof rejected")
    return out


if __name__ == "__main__":
    main()
