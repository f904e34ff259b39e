"""The repo's bench entry points, ported: counterparts of the root scripts
`bench.py`, `bench_add.py`, `bench_batch.py`, `bench_bigenc.py`,
`bench_scaling.py` and `profile_proof.py`.

Each module has `main(argv=None, device="cuda") -> dict`, which prints its
JSON line on stdout and returns it (`profile_chip` and `bench_cpu_proxy`,
the counterparts of `profile_tpu.py` and `bench_cpu_proxy.py`, too), and
runs as

    python -m paillier_halo2_tpu_torch.benches.<name> [positional ...] [--device cpu]

Positional arguments follow the JAX script's; arguments stand in for its
environment switches (`--checks` for PAILLIER_TPU_SELFCHECK in every bench
that proves). Every entry runs on the card unless the caller passes
`--device cpu` and raises where the card is missing; progress goes to
stderr. Proving keys are cached under `build/bench_keys/` (`--key-dir`); the
SRS under `plonk.srs.read_or_create_srs`'s default, the repo's `params/`,
unless `--params-dir` names another directory.
"""
from __future__ import annotations

import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEY_DIR = os.path.join(REPO, "build", "bench_keys")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check_device(device) -> str:
    """The device's name (`torch.cuda.get_device_name` on the card, "cpu"
    on the CPU); raises where a CUDA device is asked for and absent."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device!r}; pass --device cpu to run on the CPU")
        return torch.cuda.get_device_name(dev)
    return dev.type


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    """(fn(), seconds), the device synchronized before and after."""
    sync(device)
    t0 = time.monotonic()
    out = fn()
    sync(device)
    return out, time.monotonic() - t0


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_device_bytes(device) -> int | None:
    """`torch.cuda.max_memory_allocated` since the last `reset_peak`; None
    on the CPU, where no device memory is measured."""
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None


def enc_input(prng: random.Random, enc_bits: int, limb_bits: int):
    """The JAX scripts' encryption inputs: n odd with its top bit set, then
    g, m and r, all drawn from `prng`."""
    from ..bignum.host import paillier_enc_native
    from ..harness.circuits import PaillierEncryptionInput

    n = prng.getrandbits(enc_bits) | (1 << (enc_bits - 1)) | 1
    g, m, r = (prng.getrandbits(enc_bits) for _ in range(3))
    return PaillierEncryptionInput(enc_bits=enc_bits, limb_bits=limb_bits, n=n, g=g, m=m, r=r,
                                   res=paillier_enc_native(n, g, m, r))


def synth(circuit, inp, lookup_bits: int):
    """One circuit in a fresh Context, finalized."""
    from ..gadgets.context import Context
    from ..gadgets.range import RangeChip

    ctx = Context()
    circuit(ctx, RangeChip(ctx, lookup_bits), inp)
    return ctx.finalize()


def prove_verify(pk, srs, table, device, prove=None, check=None,
                 checks: str = "closing") -> tuple[dict, bytes]:
    """A cold proof, a warm proof with its host<->device transfers counted,
    and the verifier on the warm proof, as the JAX scripts run them.
    `prove(pk, table, checks=)` defaults to `create_proof`, `checks` to
    the prover's default self-checks; `check(step, stats)`
    runs before the warm proof and before verify with the keys measured so
    far (a deadline, a provisional line). Returns the scripts' keys and the
    warm proof."""
    from ..plonk.prover import create_proof
    from ..plonk.verifier import verify_proof
    from ..poly import ops

    prove = prove or create_proof
    check = check or (lambda step, stats: None)
    stats: dict = {}
    _, stats["proof_cold_s"] = timed(lambda: prove(pk, table, checks=checks), device)
    log(f"cold proof: {stats['proof_cold_s']:.3f}s")
    check("the warm proof", stats)
    ops.reset_transfer_counts()
    proof, t_warm = timed(lambda: prove(pk, table, checks=checks), device)
    stats.update(proof_s=t_warm, h2d=ops.TRANSFER_COUNTS["h2d"], d2h=ops.TRANSFER_COUNTS["d2h"])
    log(f"warm proof: {t_warm:.3f}s h2d={stats['h2d']} d2h={stats['d2h']}")
    check("verify", stats)
    ok, stats["verify_s"] = timed(lambda: verify_proof(pk.vk, srs, proof), device)
    stats.update(verified=bool(ok), proof_bytes=len(proof), proofs_per_sec=1.0 / t_warm)
    return stats, proof


def cached_keygen(table, k: int, lookup_bits: int, srs, path: str, device,
                  force: bool = False):
    """Cache-first keygen (`bench.py`, `bench_add.py`): load the key at
    `path` when its table fingerprint matches `table`'s, else run keygen
    and save the key there. Returns (pk, keygen seconds or None where the
    key was loaded). The port's fingerprint is `v2`, so a key the JAX
    package saved (`v1`) never matches and is replaced."""
    from ..plonk.keygen import keygen
    from ..plonk.serialize import load_proving_key, save_proving_key, table_fingerprint

    fp = table_fingerprint(table, k, lookup_bits)
    if os.path.exists(path) and not force:
        try:
            pk = load_proving_key(path, srs, expect_table_fp=fp, device=device)
            log(f"loaded cached pk {path} (fingerprint {fp})")
            return pk, None
        except (OSError, ValueError, KeyError) as e:
            log(f"pk cache unusable ({e!r}); fresh keygen")
    pk, t_keygen = timed(lambda: keygen(table, k, lookup_bits, srs), device)
    log(f"keygen: {t_keygen:.3f}s advice={pk.vk.num_advice}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_proving_key(pk, path, table_fp=fp)
    return pk, t_keygen
