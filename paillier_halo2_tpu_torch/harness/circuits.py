"""Reusable Paillier circuit builders + input bundles — the public items of
the reference's bench module (upstream src/bench.rs:11-117):
`PaillierEncryptionInput`, `PaillierAddCipherInput`, `paillier_enc_test`,
`paillier_enc_add_test`. These are the de-facto consumer integration API
(SURVEY.md section 3.5): each takes the witness pool (here: `Context`) and a
`RangeChip`, assigns the inputs, runs the gadget, and asserts the result both
at witness level (host assert) and constraint level (`assert_equal_fresh`) —
the double-assert pattern of upstream src/bench.rs:57-74.
`paillier_enc_batch` synthesizes many encryption statements into one merged
table through the witness pool, as the upstream bench's `pool.main()` does
(src/bench.rs:3,38).

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/harness/circuits.py:1`.
"""
from __future__ import annotations

import dataclasses
import functools

from ..gadgets.biguint import BigUintChip
from ..gadgets.context import Cells, Context, SinglePhaseCoreManager, SynthPool
from ..gadgets.paillier import EncryptionPublicKeyAssigned, PaillierChip
from ..gadgets.range import RangeChip


@dataclasses.dataclass(frozen=True)
class PaillierEncryptionInput:
    """Mirror of upstream src/bench.rs:11-20 (host ints in place of
    num_bigint::BigUint)."""

    enc_bits: int
    limb_bits: int
    n: int
    g: int
    m: int
    r: int
    res: int


@dataclasses.dataclass(frozen=True)
class PaillierAddCipherInput:
    """Mirror of upstream src/bench.rs:22-31."""

    limb_bits: int
    enc_bits: int
    n: int
    g: int
    c1: int
    c2: int
    res: int


def paillier_enc_test(ctx: Context, range_chip: RangeChip, input: PaillierEncryptionInput):
    """Mirror of upstream src/bench.rs:33-75: assign n/g/m/r, run
    `encrypt`, assert the ciphertext equals `res` (assigned at enc_bits*2,
    because the modulus n^2 < 2^(2*enc_bits)) at both witness and constraint
    level. Returns the assigned ciphertext."""
    bu = BigUintChip(range_chip, input.limb_bits)
    pc = PaillierChip.construct(bu, input.enc_bits)
    n = bu.assign_integer(input.n, input.enc_bits)
    g = bu.assign_integer(input.g, input.enc_bits)
    m = bu.assign_integer(input.m, input.enc_bits)
    r = bu.assign_integer(input.r, input.enc_bits)
    pk = EncryptionPublicKeyAssigned(n, g)
    c = pc.encrypt(pk, m, r)
    expected = bu.assign_integer(input.res, input.enc_bits * 2)
    # witness-level assert (bench.rs:57-63 value().zip().map(assert_eq))
    assert c.value() == expected.value(), (
        f"witness ciphertext {c.value():#x} != expected {expected.value():#x}"
    )
    bu.assert_equal_fresh(c, expected)
    return c


def paillier_enc_add_test(ctx: Context, range_chip: RangeChip, input: PaillierAddCipherInput):
    """Mirror of upstream src/bench.rs:77-117: assign n/g/c1/c2, run
    `add`, double-assert against `res`. Returns the assigned sum ciphertext."""
    bu = BigUintChip(range_chip, input.limb_bits)
    pc = PaillierChip.construct(bu, input.enc_bits)
    n = bu.assign_integer(input.n, input.enc_bits)
    g = bu.assign_integer(input.g, input.enc_bits)
    # ciphertext inputs assigned at enc_bits, like bench.rs:98-104 (the bench
    # generates c1/c2 as enc_bits-wide randoms, not full-width ciphertexts)
    c1 = bu.assign_integer(input.c1, input.enc_bits)
    c2 = bu.assign_integer(input.c2, input.enc_bits)
    pk = EncryptionPublicKeyAssigned(n, g)
    c = pc.add(pk, c1, c2)
    expected = bu.assign_integer(input.res, input.enc_bits * 2)
    assert c.value() == expected.value(), (
        f"witness sum {c.value():#x} != expected {expected.value():#x}"
    )
    bu.assert_equal_fresh(c, expected)
    return c


def _enc_instance(ctx: Context, i: int, inputs: tuple, lookup_bits: int) -> Cells:
    """Statement i of a batch in its own Context; returns the ciphertext's
    limb cells. Top level, so that it pickles for the pool's spawn workers;
    it touches no torch tensor."""
    return paillier_enc_test(ctx, RangeChip(ctx, lookup_bits), inputs[i]).limbs


def paillier_enc_batch(inputs, lookup_bits: int, pool: SynthPool | None = None,
                       stats: dict | None = None, n_workers: int | None = None
                       ) -> tuple:
    """The batched encryption circuit: every `PaillierEncryptionInput` of
    `inputs` synthesized by `paillier_enc_test` in its own Context, through
    `SinglePhaseCoreManager.synth_parallel` (a kept `pool`, else a pool of
    `n_workers` for the call; 1 runs serially), merged in the inputs' order.

    Returns (the merged `VirtualTable`, one int64 array per input: the row
    indices in the merged table of its ciphertext's limbs, least significant
    first). `stats` receives `synth_parallel`'s."""
    inputs = tuple(inputs)
    fn = functools.partial(_enc_instance, inputs=inputs, lookup_bits=lookup_bits)
    cipher_idx: list = []
    table = SinglePhaseCoreManager.synth_parallel(fn, len(inputs), n_workers, stats=stats,
                                                  pool=pool, outputs=cipher_idx)
    return table, cipher_idx
