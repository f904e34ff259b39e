"""Entry points of the PyTorch port: the single-card constraint check and
the multi-device dry run.

Counterparts of `entry()` and `dryrun_multichip(n)` in the repository's
`__graft_entry__.py`. `entry` returns the MockProver's constraint evaluation
(`mock.prover.check_constraints`: gates, lookups, copies and constants over
the witness table of a Paillier addition circuit), the compute heart of the
framework's test path. `dryrun_multichip` drives the distributed prover's
three communication patterns and the whole distributed proving step over an
n-shard mesh at small sizes.
"""
from __future__ import annotations

import functools
import random
import sys
import time

import torch

from .bignum.host import paillier_add_native
from .ec import bn254
from .ec import host as ech
from .ff import field as f
from .ff.host import FR_MOD
from .gadgets import BigUintChip, Context, EncryptionPublicKeyAssigned, PaillierChip
from .gadgets.range import RangeChip
from .mesh.msm import msm_sharded
from .mesh.ntt import ntt_natural
from .mesh.sharding import make_mesh, on, shard_batch, sum_shards
from .mock.prover import check_constraints, index_tensor, pack_witness, require_device
from .plonk.distributed import create_proof_sharded, keygen_sharded
from .plonk.srs import generate_srs
from .plonk.verifier import verify_proof
from .poly.ntt import ntt


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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The distributed proving step over `make_mesh(n_devices, device)`
    (`__graft_entry__.py:117-215`), each phase checked and its seconds
    printed to stderr:

    1. the four-step NTT at k = max(6, 2 * bitlen(n - 1) + 2), equal to the
       single-device NTT;
    2. a sharded MSM of 4n host points at window 4, equal to the host's;
    3. the small table's gate check with its rows sharded, K1 on each shard
       and the violation counts summed across shards: none;
    4. `keygen_sharded` and `create_proof_sharded` on the small table at
       k = max(9, 2 * bitlen(n - 1) + 2), verified.

    Raises on a failed check."""
    t_start = time.monotonic()

    def _t(msg):
        print(f"[dryrun {time.monotonic() - t_start:6.1f}s] {msg}", file=sys.stderr, flush=True)

    rng = random.Random(9)
    mesh = make_mesh(n_devices, device)
    dev = mesh.devices[0]
    _t(f"mesh up: {mesh.size} shards on {mesh.n_cards} card(s)")

    # 1. four-step NTT (all-to-all): needs d^2 | n
    k = max(6, 2 * (n_devices - 1).bit_length() + 2)
    x = f.to_mont(f.FR, f.pack_ints([rng.randrange(FR_MOD) for _ in range(1 << k)], dev))
    if not torch.equal(ntt_natural(mesh, x, k), ntt(x, k)):
        raise RuntimeError("dry run: the distributed NTT differs from the single-device NTT")
    _t(f"phase 1 (distributed NTT, k={k}) done")

    # 2. sharded MSM (per-shard buckets + cross-shard point-add tree)
    n_pts = 4 * n_devices
    pts = [ech.g1_mul(ech.G1, rng.randrange(1, ech.R)) for _ in range(n_pts)]
    scalars = [rng.randrange(ech.R) for _ in range(n_pts)]
    px, py, pinf = bn254.pack_affine(pts, dev)
    got = msm_sharded(mesh, px, py, pinf, f.pack_ints(scalars, dev), window_bits=4)
    if got != ech.g1_msm(pts, scalars):
        raise RuntimeError("dry run: the sharded MSM differs from the host's")
    _t("phase 2 (sharded MSM) done")

    # 3. row-sharded constraint check (data-parallel over gate rows)
    table, lk = build_small_table()
    w = pack_witness(table.values, torch.empty((8, table.n_rows), dtype=torch.int32, device=dev))
    gates = index_tensor(table.gates, dev)
    pad = (-gates.shape[0]) % n_devices
    gates = torch.cat([gates, gates[-1:].expand(pad)])
    counts = []
    for g_shard, w_rep in zip(shard_batch(mesh, gates), (w.to(d) for d in mesh.devices)):
        with on(g_shard.device):
            a, b, c, d = (w_rep.index_select(1, g_shard + i) for i in range(4))
            s = f.add(f.FR, a, f.mont_mul(f.FR, f.to_mont(f.FR, b), c))
            counts.append((~f.is_zero(f.sub(f.FR, s, d))).sum())
    n_bad = int(sum_shards(counts, dev))
    if n_bad:
        raise RuntimeError(f"dry run: {n_bad} gate violations")
    _t("phase 3 (row-sharded constraint check) done")

    # 4. the distributed proving step: four-step NTTs and sharded commitments
    # inside the ordinary keygen and prover, checked by the verifier.
    # lookup_bits=8 needs 2^8 table rows below n - blinding; d^2 | n.
    k = max(9, 2 * (n_devices - 1).bit_length() + 2)
    srs = generate_srs(k, b"", dev)
    _t(f"phase 4: srs k={k} ready")
    pk = keygen_sharded(mesh, table, k, lk, srs)
    _t("phase 4: distributed keygen done")
    proof = create_proof_sharded(mesh, pk, table)
    _t("phase 4: distributed proof done")
    if not verify_proof(pk.vk, srs, proof):
        raise RuntimeError("dry run: the distributed proof does not verify")
    _t("phase 4: verified; dry run complete")
