"""Write the slice fixture that the PyTorch port's proof is held against.

Runs the JAX reference package on the CPU through the main path at a small
size: the K=10, lookup_bits=9, ENC=16/LIMB=8 Paillier encryption circuit,
SRS seed b"plonk-test", blinding seed b"test-blind", SHPLONK multi-open. The
circuit inputs come from `random.Random(SEED)`. It writes
`tests/torch_fixtures/slice_enc_k10.json` with the inputs, the seeds, the
verifying-key commitments and the proof bytes in hex.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_slice_fixture.py

On an 8-core x86 CPU it takes 4 to 5 minutes (252 s and 297 s in two runs).
"""
from __future__ import annotations

import json
import os
import random
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from paillier_halo2_tpu.bignum.host import paillier_enc_native  # noqa: E402
from paillier_halo2_tpu.gadgets.context import Context  # noqa: E402
from paillier_halo2_tpu.gadgets.range import RangeChip  # noqa: E402
from paillier_halo2_tpu.harness.circuits import (  # noqa: E402
    PaillierEncryptionInput,
    paillier_enc_test,
)
from paillier_halo2_tpu.plonk.keygen import keygen  # noqa: E402
from paillier_halo2_tpu.plonk.prover import create_proof  # noqa: E402
from paillier_halo2_tpu.plonk.srs import generate_srs  # noqa: E402
from paillier_halo2_tpu.plonk.verifier import verify_proof  # noqa: E402

K, LOOKUP_BITS, ENC, LIMB = 10, 9, 16, 8
SEED = 10
SRS_SEED = b"plonk-test"
BLIND_SEED = b"test-blind"
OUT = os.path.join(HERE, "slice_enc_k10.json")


def circuit_input(seed: int = SEED) -> PaillierEncryptionInput:
    prng = random.Random(seed)
    n = prng.getrandbits(ENC) | (1 << (ENC - 1)) | 1
    g, m, r = (prng.getrandbits(ENC) for _ in range(3))
    return PaillierEncryptionInput(
        enc_bits=ENC, limb_bits=LIMB, n=n, g=g, m=m, r=r,
        res=paillier_enc_native(n, g, m, r),
    )


def _pt(p):
    return None if p is None else ["%x" % p[0], "%x" % p[1]]


def main() -> None:
    t0 = time.monotonic()
    inp = circuit_input()
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, LOOKUP_BITS), inp)
    table = ctx.finalize()
    srs = generate_srs(K, seed=SRS_SEED)
    pk = keygen(table, K, LOOKUP_BITS, srs)
    proof = create_proof(pk, table, blinding_seed=BLIND_SEED)
    ok = verify_proof(pk.vk, srs, proof)
    assert ok, "reference proof does not verify"
    vk = pk.vk
    out = {
        "k": K,
        "lookup_bits": LOOKUP_BITS,
        "enc_bits": ENC,
        "limb_bits": LIMB,
        "input_seed": SEED,
        "inputs": {key: getattr(inp, key) for key in ("n", "g", "m", "r", "res")},
        "srs_seed": SRS_SEED.decode(),
        "blinding_seed": BLIND_SEED.decode(),
        "multiopen": vk.multiopen,
        "n_rows": table.n_rows,
        "num_advice": vk.num_advice,
        "num_lookup_advice": vk.num_lookup_advice,
        "vk": {
            "q_commits": [_pt(p) for p in vk.q_commits],
            "fixed_const_commit": _pt(vk.fixed_const_commit),
            "table_commit": _pt(vk.table_commit),
            "sigma_commits": [_pt(p) for p in vk.sigma_commits],
        },
        "proof_hex": proof.hex(),
    }
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT}: {len(proof)} proof bytes, {time.monotonic() - t0:.1f} s")


if __name__ == "__main__":
    main()
