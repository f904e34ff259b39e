"""Write the fixtures that the PyTorch port's proofs are held against.

Runs the JAX reference package on the CPU through the main path at a small
size, K=10, lookup_bits=9, ENC=16/LIMB=8, and writes one JSON file per
fixture with the inputs, the seeds, the verifying-key commitments and the
proof bytes in hex:

- `slice`: `slice_enc_k10.json`, the Paillier encryption circuit with inputs
  from `random.Random(10)`, SRS seed b"plonk-test", blinding seed
  b"test-blind", SHPLONK multi-open;
- `gwc`: `slice_enc_k10_gwc.json`, the same circuit and seeds under GWC
  multi-open (PAILLIER_TPU_MULTIOPEN=gwc, set in this process only);
- `instance`: `instance_enc_k10.json`, the statement of
  `tests/test_instance.py` (inputs from `random.Random(23)`, n, g and the
  ciphertext exposed as public inputs), the seed-b"" SRS, blinding seed
  b"\x21" * 32, SHPLONK; it also holds the public values;
- `dist`: `dist_add_k10.json`, the circuit of `tests/test_distributed.py`'s
  sharded-proof test: two Paillier additions (ENC=16/LIMB=8, inputs from
  `random.Random(2024)` and `random.Random(2025)`) at K=10, lookup_bits=9,
  the seed-b"" SRS, blinding seed b"dist-test", SHPLONK, proved on one
  device (the distributed prover's bytes must equal these);
- `batch`: `batch_k10.json`, `bench_batch.py`'s batched circuit at B=2
  (ENC=8/LIMB=4, which halves the CPU proof's columns against ENC=16;
  instance i from `random.Random(1 + i)`, as its `synth_one`) merged by
  `SinglePhaseCoreManager.synth_parallel`, K=10, lookup_bits=9, the
  seed-b"" SRS, blinding seed b"batch-test", SHPLONK;
- `bench`: `bench_enc_k10.json`, the encryption circuit of
  `tests/test_bench_harness.py::test_bench_builder_enc` (inputs from the
  first draws of `random.Random(14)`) as `harness.bench.bench_builder`
  proves it: the seed-b"" SRS that `read_or_create_srs` caches, keygen on
  the shape table, blinding seed b"bench-enc" (the harness draws fresh
  randomness; the port's test passes this seed in), SHPLONK;
- `multicolumn`: `multicolumn_add_k9.json`, the circuit of
  `tests/test_plonk.py::test_quotient_degree_selfcheck_multicolumn`: three
  Paillier additions (inputs from `random.Random(31337)`) at K=9,
  lookup_bits=8, wide enough for several advice columns, SRS seed
  b"plonk-test-mc", blinding seed b"degree-check-mc", SHPLONK.

Run from the repository root, naming the fixtures to write (all seven by
default):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_slice_fixture.py gwc instance

On an 8-core x86 CPU each takes 4 to 9 minutes (`slice`: 252 s and 297 s in
two runs; `gwc` 498 s and `instance` 506 s, run side by side; `batch` 321 s
while another process shared the cores).
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

from paillier_halo2_tpu.bignum.host import paillier_add_native, paillier_enc_native  # noqa: E402
from paillier_halo2_tpu.gadgets import (  # noqa: E402
    BigUintChip,
    EncryptionPublicKeyAssigned,
    PaillierChip,
)
from paillier_halo2_tpu.gadgets.context import Context, SinglePhaseCoreManager  # noqa: E402
from paillier_halo2_tpu.gadgets.range import RangeChip  # noqa: E402
from paillier_halo2_tpu.harness.circuits import (  # noqa: E402
    PaillierAddCipherInput,
    PaillierEncryptionInput,
    paillier_enc_add_test,
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
INSTANCE_SEED, INSTANCE_BLIND = 23, b"\x21" * 32
DIST_SEED, DIST_BLIND = 2024, b"dist-test"
BATCH, BATCH_SEED, BATCH_BLIND, BATCH_ENC, BATCH_LIMB = 2, 1, b"batch-test", 8, 4
BENCH_SEED, BENCH_BLIND = 14, b"bench-enc"
MC_SEED, MC_K, MC_LOOKUP_BITS, MC_BLIND = 31337, 9, 8, b"degree-check-mc"


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


def instance_table(seed: int = INSTANCE_SEED):
    """`tests/test_instance.py`'s statement: n, g and the ciphertext limbs
    exposed as public inputs. Returns (inputs, table)."""
    prng = random.Random(seed)
    n = prng.getrandbits(ENC) | (1 << (ENC - 1)) | 1
    g, m, r = (prng.getrandbits(ENC) for _ in range(3))
    res = paillier_enc_native(n, g, m, r)
    ctx = Context()
    bu = BigUintChip(RangeChip(ctx, LOOKUP_BITS), LIMB)
    pc = PaillierChip.construct(bu, ENC)
    n_a, g_a = bu.assign_integer(n, ENC), bu.assign_integer(g, ENC)
    c = pc.encrypt(EncryptionPublicKeyAssigned(n_a, g_a), bu.assign_integer(m, ENC),
                   bu.assign_integer(r, ENC))
    res_a = bu.assign_integer(res, ENC * 2)
    bu.assert_equal_fresh(c, res_a)
    for cells in (n_a.limbs, g_a.limbs, res_a.limbs):
        ctx.expose_public(cells)
    return {"n": n, "g": g, "m": m, "r": r, "res": res}, ctx.finalize()


def add_table(seed: int = DIST_SEED):
    """`tests/test_distributed.py::_add_table`: two Paillier additions, the
    i-th from `random.Random(seed + i)`. Returns (inputs, table)."""
    return _additions([random.Random(seed + i) for i in range(2)], LOOKUP_BITS)


def multicolumn_table():
    """Three Paillier additions drawn in turn from `random.Random(MC_SEED)`,
    lookup_bits=8. Returns (inputs, table)."""
    return _additions([random.Random(MC_SEED)] * 3, MC_LOOKUP_BITS)


def _additions(rngs, lookup_bits: int):
    """One Paillier addition per generator in `rngs`, each drawing n, g,
    c1 and c2. Returns (inputs, table)."""
    ctx = Context()
    rc = RangeChip(ctx, lookup_bits)
    inputs = []
    for rng in rngs:
        n = rng.getrandbits(ENC) | (1 << (ENC - 1)) | 1
        g, c1, c2 = (rng.getrandbits(ENC) for _ in range(3))
        inp = PaillierAddCipherInput(limb_bits=LIMB, enc_bits=ENC, n=n, g=g, c1=c1, c2=c2,
                                     res=paillier_add_native(n, c1, c2))
        paillier_enc_add_test(ctx, rc, inp)
        inputs.append({key: getattr(inp, key) for key in ("n", "g", "c1", "c2", "res")})
    return inputs, ctx.finalize()


def batch_one(ctx, i: int) -> None:
    """`bench_batch.py:29-50`'s `synth_one` at the batch fixture's geometry:
    the i-th encryption from `random.Random(BATCH_SEED + i)`."""
    rng = random.Random(BATCH_SEED + i)
    n = rng.getrandbits(BATCH_ENC) | (1 << (BATCH_ENC - 1)) | 1
    g, m, r = (rng.getrandbits(BATCH_ENC) for _ in range(3))
    inp = PaillierEncryptionInput(enc_bits=BATCH_ENC, limb_bits=BATCH_LIMB, n=n, g=g, m=m, r=r,
                                  res=paillier_enc_native(n, g, m, r))
    paillier_enc_test(ctx, RangeChip(ctx, LOOKUP_BITS), inp)


def batch_table():
    """The B=2 batched circuit, merged in instance order (serially: the
    merge does not depend on the workers). Returns (inputs, table)."""
    inputs = []
    for i in range(BATCH):
        rng = random.Random(BATCH_SEED + i)
        n = rng.getrandbits(BATCH_ENC) | (1 << (BATCH_ENC - 1)) | 1
        g, m, r = (rng.getrandbits(BATCH_ENC) for _ in range(3))
        inputs.append({"n": n, "g": g, "m": m, "r": r, "res": paillier_enc_native(n, g, m, r)})
    return inputs, SinglePhaseCoreManager.synth_parallel(batch_one, BATCH, n_workers=1)


def make(which: str) -> None:
    t0 = time.monotonic()
    k, lookup_bits = K, LOOKUP_BITS
    if which == "instance":
        inputs, table = instance_table()
        input_seed, srs_seed, blind = INSTANCE_SEED, b"", INSTANCE_BLIND
    elif which == "dist":
        inputs, table = add_table()
        input_seed, srs_seed, blind = DIST_SEED, b"", DIST_BLIND
    elif which == "batch":
        inputs, table = batch_table()
        input_seed, srs_seed, blind = BATCH_SEED, b"", BATCH_BLIND
    elif which == "multicolumn":
        inputs, table = multicolumn_table()
        input_seed, srs_seed, blind = MC_SEED, b"plonk-test-mc", MC_BLIND
        k, lookup_bits = MC_K, MC_LOOKUP_BITS
    else:
        inp = circuit_input(BENCH_SEED if which == "bench" else SEED)
        inputs = {key: getattr(inp, key) for key in ("n", "g", "m", "r", "res")}
        ctx = Context()
        paillier_enc_test(ctx, RangeChip(ctx, LOOKUP_BITS), inp)
        table = ctx.finalize()
        input_seed, srs_seed, blind = SEED, SRS_SEED, BLIND_SEED
        if which == "bench":
            input_seed, srs_seed, blind = BENCH_SEED, b"", BENCH_BLIND
    if which == "gwc":
        os.environ["PAILLIER_TPU_MULTIOPEN"] = "gwc"
    try:
        srs = generate_srs(k, seed=srs_seed)
        pk = keygen(table, k, lookup_bits, srs)
    finally:
        os.environ.pop("PAILLIER_TPU_MULTIOPEN", None)
    proof = create_proof(pk, table, blinding_seed=blind)
    publics = table.public_values() if which == "instance" else None
    assert verify_proof(pk.vk, srs, proof, instances=publics), "reference proof does not verify"
    vk = pk.vk
    out = {
        "k": k,
        "lookup_bits": lookup_bits,
        "enc_bits": BATCH_ENC if which == "batch" else ENC,
        "limb_bits": BATCH_LIMB if which == "batch" else LIMB,
        "input_seed": input_seed,
        "inputs": inputs,
        "srs_seed": srs_seed.decode(),
        "blinding_seed": blind.decode(),
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
    if publics is not None:
        out["num_instance"] = vk.num_instance
        out["publics"] = publics
    path = os.path.join(HERE, FIXTURES[which])
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(f"wrote {path}: {len(proof)} proof bytes, {time.monotonic() - t0:.1f} s")


FIXTURES = {"slice": "slice_enc_k10.json", "gwc": "slice_enc_k10_gwc.json",
            "instance": "instance_enc_k10.json", "dist": "dist_add_k10.json",
            "batch": "batch_k10.json", "bench": "bench_enc_k10.json",
            "multicolumn": "multicolumn_add_k9.json"}


def main() -> None:
    for which in sys.argv[1:] or list(FIXTURES):
        if which not in FIXTURES:
            raise SystemExit(f"unknown fixture {which!r}; choose from {sorted(FIXTURES)}")
        make(which)


if __name__ == "__main__":
    main()
