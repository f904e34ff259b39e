"""Batched-proving bench (BASELINE.json config 4): B independent Paillier
encryptions in ONE circuit, synthesized by the witness pool, then SRS,
keygen, a cold and a warm KZG proof and verify; reports proofs/s
(B / warm proof time) and per-phase seconds.

Counterpart of `bench_batch.py:1-127`:

    python -m paillier_halo2_tpu_torch.benches.bench_batch [B] [k] [lookup_bits] [enc_bits]
        [--mesh N] [--device cpu] [--params-dir DIR]

Defaults: B=64, k=17, lookup_bits=k-1, enc=128 (limbs of 64 bits where 64
divides enc, else 88). `--mesh N` (for PAILLIER_TPU_MESH) proves through
`plonk.distributed.create_proof_sharded` on `make_mesh(N, device)`; an
indexed device such as `cuda:0` puts every shard on one card.
"""
from __future__ import annotations

import argparse
import functools
import json
import random


def synth_one(ctx, i: int, lookup_bits: int = 16, enc_bits: int = 128, limb_bits: int = 64,
              seed: int = 1) -> None:
    """Instance i in its own Context, its inputs from `random.Random(seed +
    i)` (`bench_batch.py:29-50`). Top level, so that it pickles for the
    pool's spawn workers; it touches no torch tensor."""
    from ..gadgets.range import RangeChip
    from ..harness.circuits import paillier_enc_test
    from . import enc_input

    paillier_enc_test(ctx, RangeChip(ctx, lookup_bits),
                      enc_input(random.Random(seed + i), enc_bits, limb_bits))


def synthesize(batch: int, lookup_bits: int, enc_bits: int, limb_bits: int,
               n_workers: int | None = None):
    """The batched table through `SinglePhaseCoreManager.synth_parallel`;
    returns (table, the number of pool workers that synthesized: 1 where
    it ran serially, pool error or None)."""
    from ..gadgets.context import SinglePhaseCoreManager

    stats: dict = {}
    table = SinglePhaseCoreManager.synth_parallel(
        functools.partial(synth_one, lookup_bits=lookup_bits, enc_bits=enc_bits,
                          limb_bits=limb_bits), batch, n_workers, stats=stats)
    return table, stats["workers"], stats["pool_error"]


def run(batch: int = 64, k: int = 17, lookup_bits: int | None = None, enc_bits: int = 128,
        device="cuda", mesh: int = 0, params_dir: str | None = None):
    """The bench; returns (its JSON keys, (pk, srs, table, proof))."""
    from ..plonk.distributed import create_proof_sharded
    from ..plonk.keygen import keygen
    from ..plonk.prover import create_proof
    from ..plonk.srs import read_or_create_srs
    from . import check_device, log, peak_device_bytes, prove_verify, reset_peak, timed

    lk = k - 1 if lookup_bits is None else lookup_bits
    limb = 64 if enc_bits % 64 == 0 else 88
    name = check_device(device)
    log(f"device: {name}; B={batch} k={k} lookup={lk} enc={enc_bits}")
    reset_peak(device)
    (table, workers, pool_error), t_synth = timed(
        lambda: synthesize(batch, lk, enc_bits, limb), device)
    log(f"synthesized {table.n_rows} rows in {t_synth:.3f}s ({workers} pool workers"
        f"{'' if pool_error is None else f'; the pool failed: {pool_error}'})")
    srs = read_or_create_srs(k, device=device, params_dir=params_dir)
    pk, t_keygen = timed(lambda: keygen(table, k, lk, srs), device)
    log(f"keygen {t_keygen:.3f}s (advice columns: {pk.vk.num_advice})")
    prove = create_proof
    if mesh > 1:
        from ..mesh.sharding import make_mesh

        prove = functools.partial(create_proof_sharded, make_mesh(mesh, device))
    stats, proof = prove_verify(pk, srs, table, device, prove)
    out = {"batch": batch, "k": k, "enc_bits": enc_bits, "rows": int(table.n_rows),
           "advice_cols": pk.vk.num_advice, "synth_s": t_synth, "synth_workers": workers,
           "keygen_s": t_keygen, "proof_cold_s": stats["proof_cold_s"],
           "proof_s": stats["proof_s"], "verify_s": stats["verify_s"],
           "verified": stats["verified"], "proof_bytes": stats["proof_bytes"],
           "proofs_per_sec": batch / stats["proof_s"], "mesh": mesh,
           "peak_device_bytes": peak_device_bytes(device), "device": name}
    return out, (pk, srs, table, proof)


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description="Batched-proving bench (BASELINE.json config 4)")
    ap.add_argument("batch", nargs="?", type=int, default=64)
    ap.add_argument("k", nargs="?", type=int, default=17)
    ap.add_argument("lookup_bits", nargs="?", type=int, default=None, help="default k - 1")
    ap.add_argument("enc_bits", nargs="?", type=int, default=128)
    ap.add_argument("--mesh", type=int, default=0, help="shards of the distributed prover")
    ap.add_argument("--device", default=device)
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    a = ap.parse_args(argv)
    out, _ = run(a.batch, a.k, a.lookup_bits, a.enc_bits, a.device, a.mesh, a.params_dir)
    print(json.dumps(out), flush=True)
    if not out["verified"]:
        raise RuntimeError("proof rejected")
    return out


if __name__ == "__main__":
    main()
