"""The PyTorch port's MockProver against the JAX package's, on the CPU.

Tables are synthesized by the JAX package's gadgets from one seed, and the
port's `VirtualTable` is built from the JAX table's arrays, so both mocks
see the same table. The port runs its plain K1 here (CPU tensors). The
failure arrays must be equal, in the same order and dtype, on satisfied and
tampered tables, one-shot and chunked, with tampered rows in a chunk's
3-row overlap and at a chunk's first row.
"""
import dataclasses
import os
import random

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from paillier_halo2_tpu.bignum.host import paillier_add_native, paillier_enc_native
from paillier_halo2_tpu.gadgets import (
    BigUintChip as JBigUintChip,
    Context as JContext,
    EncryptionPublicKeyAssigned as JPk,
    PaillierChip as JPaillierChip,
)
from paillier_halo2_tpu.gadgets.context import VirtualTable as JVirtualTable
from paillier_halo2_tpu.gadgets.range import RangeChip as JRangeChip
from paillier_halo2_tpu.harness import circuits as jcirc
from paillier_halo2_tpu.harness.base_test import base_test as jbase_test
from paillier_halo2_tpu.mock import prover as jmock
from paillier_halo2_tpu.plonk.params import ConfigParams as JConfigParams
from paillier_halo2_tpu_torch.entry import entry
from paillier_halo2_tpu_torch.ff.host import FR_MOD
from paillier_halo2_tpu_torch.gadgets import BigUintChip, EncryptionPublicKeyAssigned, PaillierChip
from paillier_halo2_tpu_torch.gadgets.context import VirtualTable
from paillier_halo2_tpu_torch.harness.base_test import base_test
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
from paillier_halo2_tpu_torch.mock import prover as tmock

# pytest-xdist workers share the machine's cores: each worker's torch takes
# its share instead of all of them, so workers do not oversubscribe the CPU.
torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

FIELDS = ("satisfied", "gate_failures", "lookup_failures", "copy_failures", "const_failures")


def _jax_enc_table(enc, limb, lk, seed):
    """`tests/test_mock_chunked.py`'s circuit: an encryption at enc/limb,
    synthesized by the JAX package."""
    rng = random.Random(seed)
    n = rng.getrandbits(enc) | 1
    g, m, r = (rng.getrandbits(enc) for _ in range(3))
    ctx = JContext()
    bu = JBigUintChip(JRangeChip(ctx, lk), limb)
    pc = JPaillierChip.construct(bu, enc)
    pk = JPk(bu.assign_integer(n, enc), bu.assign_integer(g, enc))
    c = pc.encrypt(pk, bu.assign_integer(m, enc), bu.assign_integer(r, enc))
    bu.assert_equal_fresh(c, bu.assign_integer(paillier_enc_native(n, g, m, r), enc * 2))
    return ctx.finalize()


def _port_table(jt) -> VirtualTable:
    return VirtualTable(jt.values.copy(), jt.gates, jt.copy_a, jt.copy_b, jt.const_idx,
                        jt.const_val, jt.lookups, jt.publics)


def _tamper(jt, rows, lk, far_rows=()):
    """A copy of the JAX table with each of `rows` set to (v + 1) mod p,
    and lookup cells out of range: the first and `far_rows` at 2^lk, the
    second at 2^31 + 5 (a low limb that reads negative as int32)."""
    vals = jt.values.copy()
    for r in rows:
        vals[r] = (int(vals[r]) + 1) % FR_MOD
    for r in (int(jt.lookups[0]), *far_rows):
        vals[r] = 1 << lk
    vals[int(jt.lookups[1])] = (1 << 31) + 5
    return JVirtualTable(vals, jt.gates, jt.copy_a, jt.copy_b, jt.const_idx, jt.const_val,
                         jt.lookups, jt.publics)


def _assert_same(port, ref):
    for name in FIELDS:
        a, b = getattr(port, name), getattr(ref, name)
        if name == "satisfied":
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, a, b)


@pytest.fixture(scope="module")
def enc32():
    return _jax_enc_table(32, 16, 13, 20260817)


@pytest.mark.parametrize("tampered", [False, True], ids=["satisfied", "tampered"])
def test_oneshot_matches_jax(enc32, tampered):
    jt = enc32
    if tampered:
        rng = np.random.default_rng(5)
        rows = [int(jt.gates[7]) + 3, int(jt.copy_a[11]), int(jt.const_idx[1]),
                *rng.integers(0, jt.n_rows, 5).tolist()]
        jt = _tamper(jt, rows, 13)
    ref_host = jmock.mock_prove_host(jt, 13)
    ref_jax = jmock.mock_prove_jax(jt, 13)
    got = tmock.mock_prove_torch(_port_table(jt), 13, device="cpu")
    _assert_same(got, ref_host)
    _assert_same(got, ref_jax)
    if tampered:
        assert all(len(getattr(got, name)) for name in FIELDS[1:])
    else:
        assert got.satisfied


@pytest.fixture(scope="module")
def chunked_geometry():
    return _jax_enc_table(32, 16, 10, 99)


@pytest.mark.parametrize("tampered", [False, True], ids=["satisfied", "tampered"])
def test_chunked_matches_jax(chunked_geometry, tampered):
    """`tests/test_mock_chunked.py`'s geometry at 2^10-row chunks; tampered:
    the three overlap rows after the first chunk's end, the first row of
    the third chunk, a gate, a copy and a constant row, and a lookup cell
    out of range in a later chunk's overlap rows."""
    chunk = 1 << 10
    jt = chunked_geometry
    if tampered:
        rows = [chunk, chunk + 1, chunk + 2, 2 * chunk, int(jt.gates[7]) + 3,
                int(jt.copy_b[5]), int(jt.const_idx[0])]
        overlap = [int(i) for i in jt.lookups if i >= 3 * chunk and i % chunk < 3]
        jt = _tamper(jt, rows, 10, far_rows=overlap[:1])
        assert overlap
    got = tmock.mock_prove_chunked(_port_table(jt), 10, chunk_rows=chunk, device="cpu")
    _assert_same(got, jmock.mock_prove_chunked(jt, 10, chunk_rows=chunk))
    _assert_same(got, jmock.mock_prove_host(jt, 10))
    if tampered:  # a gate reading the overlap rows, on either side of the end
        assert any(chunk - 3 <= g < chunk + 3 for g in got.gate_failures.tolist())


def test_empty_index_sets_match_jax():
    """No lookups, copies or constants: the padded row-0 gathers give the
    JAX package's empty arrays on both routes."""
    vals = np.empty(8, dtype=object)
    vals[:] = [1, 2, 3, 7, 0, 0, 0, 5]
    empty = np.zeros(0, dtype=np.int64)
    jt = JVirtualTable(vals, np.array([0, 4], dtype=np.int64), empty, empty, empty,
                       np.empty(0, dtype=object), empty)
    ref = jmock.mock_prove_host(jt, 8)
    assert not ref.satisfied and ref.gate_failures.tolist() == [4]
    _assert_same(tmock.mock_prove_torch(_port_table(jt), 8, device="cpu"), ref)
    _assert_same(tmock.mock_prove_chunked(_port_table(jt), 8, chunk_rows=4, device="cpu"), ref)


def test_wrong_result_is_rejected():
    """The negative of `tests/test_gadgets.py::test_mock_catches_bad_witness`:
    a false equality wired as copy constraints."""
    rng = random.Random(20260817)
    ENC, LIMB = 32, 16
    n = rng.getrandbits(ENC) | 1
    g, c1, c2 = (rng.getrandbits(ENC) for _ in range(3))
    bad = (paillier_add_native(n, c1, c2) + 1) % (n * n)

    def closure(chips):
        biguint_chip, paillier_chip, pk_cls = chips

        def run(ctx, rc):
            bu = biguint_chip(rc, LIMB)
            pc = paillier_chip.construct(bu, ENC)
            pk = pk_cls(bu.assign_integer(n, ENC), bu.assign_integer(g, ENC))
            c = pc.add(pk, bu.assign_integer(c1, ENC), bu.assign_integer(c2, ENC))
            ctx.add_copies(c.limbs.idx, bu.assign_integer(bad, ENC * 2).limbs.idx)

        return run

    port = closure((BigUintChip, PaillierChip, EncryptionPublicKeyAssigned))
    got = base_test().device("cpu").expect_satisfied(False).run(port)
    ref = jbase_test().backend("host").expect_satisfied(False).run(
        closure((JBigUintChip, JPaillierChip, JPk)))
    _assert_same(got.mock, ref.mock)
    assert len(got.mock.copy_failures)
    with pytest.raises(AssertionError, match="MockProver: constraint system not satisfied"):
        base_test().device("cpu").run(port)


@pytest.mark.parametrize("backend", ["torch", "host"])
def test_base_test_run_enc128_matches_jax_host(backend):
    """The reference's encryption geometry (ENC 128 / LIMB 64, k 16, lookup
    15) through `base_test().run` on the CPU, against the JAX host oracle on
    the JAX package's table of the same inputs."""
    rng = random.Random(20260817)
    n = rng.getrandbits(128) | 1
    g, m, r = (rng.getrandbits(128) for _ in range(3))
    inp = PaillierEncryptionInput(128, 64, n, g, m, r, paillier_enc_native(n, g, m, r))
    out = (base_test().k(16).lookup_bits(15).expect_satisfied(True).backend(backend).device("cpu")
           .run(lambda ctx, rc: paillier_enc_test(ctx, rc, inp)))
    ctx = JContext()
    jcirc.paillier_enc_test(ctx, JRangeChip(ctx, 15),
                            jcirc.PaillierEncryptionInput(**dataclasses.asdict(inp)))
    jt = ctx.finalize()
    assert np.array_equal(out.table.values, jt.values)
    _assert_same(out.mock, jmock.mock_prove_host(jt, 15))
    assert dataclasses.asdict(out.config) == dataclasses.asdict(JConfigParams.size_for(jt, 16, 15))


def test_entry_masks_match_graft_entry():
    """`entry(device="cpu")`'s four masks equal those of the repository's
    `__graft_entry__.entry()` (its `_check_kernel` on the JAX package's
    table of the same circuit)."""
    jfn, jargs = __graft_entry__.entry()
    want = [np.asarray(m) for m in jax.jit(jfn)(*jargs)]
    fn, args = entry(device="cpu")
    got = [m.numpy() for m in fn(*args)]
    assert [m.shape for m in got] == [m.shape for m in want]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert not any(m.any() for m in got)


@pytest.mark.parametrize("rows,route", [(1 << 23, "one-shot"), ((1 << 23) + 1, "chunked")])
def test_cpu_route_keeps_the_jax_threshold(rows, route):
    table = VirtualTable(np.empty(rows, dtype=object), *([np.zeros(0, dtype=np.int64)] * 4),
                         np.empty(0, dtype=object), np.zeros(0, dtype=np.int64))
    assert tmock.plan_route(table, torch.device("cpu"))[0] == route
