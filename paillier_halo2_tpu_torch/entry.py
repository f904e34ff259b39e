"""Entry point of the PyTorch port: the single-card constraint check.

Counterpart of `entry()` in the repository's `__graft_entry__.py`: the
MockProver's constraint evaluation (`mock.prover.check_constraints`: gates,
lookups, copies and constants over the witness table of a Paillier addition
circuit), the compute heart of the framework's test path. Its multi-chip dry
run belongs to the port's mesh layer, which is not ported yet.
"""
from __future__ import annotations

import functools
import random

import torch

from .bignum.host import paillier_add_native
from .ff import field as f
from .ff.host import FR_MOD
from .gadgets import BigUintChip, Context, EncryptionPublicKeyAssigned, PaillierChip
from .gadgets.range import RangeChip
from .mock.prover import check_constraints, index_tensor, pack_witness, require_device


def build_small_table():
    """The 16-bit Paillier addition table (`random.Random(42)`, ENC 16,
    LIMB 8, lookup_bits 8) and its lookup_bits."""
    rng = random.Random(42)
    ENC, LIMB, LK = 16, 8, 8
    n = rng.getrandbits(ENC) | (1 << (ENC - 1)) | 1
    g, c1, c2 = (rng.getrandbits(ENC) for _ in range(3))
    res = paillier_add_native(n, c1, c2)
    ctx = Context()
    rc = RangeChip(ctx, LK)
    bu = BigUintChip(rc, LIMB)
    pc = PaillierChip.construct(bu, ENC)
    pk = EncryptionPublicKeyAssigned(bu.assign_integer(n, ENC), bu.assign_integer(g, ENC))
    c = pc.add(pk, bu.assign_integer(c1, ENC), bu.assign_integer(c2, ENC))
    bu.assert_equal_fresh(c, bu.assign_integer(res, ENC * 2))
    return ctx.finalize(), LK


def entry(device="cuda"):
    """Returns (fn, args): `check_constraints` bound to Fr and the table's
    lookup_bits, and its tensors on `device` (the witness, gate, lookup,
    copy and constant indices, the constants' limbs); `fn(*args)` gives the
    four violation masks."""
    device = require_device(device, "entry")
    table, lk = build_small_table()
    w = pack_witness(table.values, torch.empty((8, table.n_rows), dtype=torch.int32, device=device))

    fn = functools.partial(check_constraints, f.FR, lookup_bits=lk)
    args = (
        w,
        index_tensor(table.gates, device),
        index_tensor(table.lookups, device),
        index_tensor(table.copy_a, device),
        index_tensor(table.copy_b, device),
        index_tensor(table.const_idx, device),
        f.pack_ints([int(x) % FR_MOD for x in table.const_val], device),
    )
    return fn, args
