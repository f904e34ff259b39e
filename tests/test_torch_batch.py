"""The batched encryption entry (`harness.circuits.paillier_enc_batch`) and
the witness pool under it (`gadgets.context.SynthPool`,
`SinglePhaseCoreManager.synth_parallel`), on the CPU at ENC=8/LIMB=4, K=10
(the size of `tests/torch_fixtures/batch_k10.json`), B=3 under one public
key:

- each instance's returned ciphertext cells, read from the merged table,
  hold Paillier of its own statement, in any order of the statements;
- a kept pool, a pool for the call and the serial path give one table and
  one set of indices, and a kept pool starts no worker on a second call;
- a pool whose workers fail is reported, synthesis falls back to the
  serial path, and the pool is not used again;
- the benchmark's plain table check reads 0 on the merged table and more
  after one ciphertext limb is raised.
"""
import functools
import os
import random

import numpy as np
import pytest

from benchmark.reference import circuit as ref_circuit
from paillier_halo2_tpu_torch.gadgets.context import (
    Context,
    SinglePhaseCoreManager,
    SynthPool,
    merge_tables,
    row_offsets,
)
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_batch

ENC, LIMB, LOOKUP_BITS, B = 8, 4, 9, 3
TABLE_FIELDS = ("values", "gates", "copy_a", "copy_b", "const_idx", "const_val", "lookups",
                "publics")


def statements(seed: int = 7) -> list:
    """B statements under one (n, g): fresh m and r each."""
    prng = random.Random(seed)
    n = prng.getrandbits(ENC) | (1 << (ENC - 1)) | 1
    g = prng.getrandbits(ENC)
    out = []
    for _ in range(B):
        m, r = prng.getrandbits(ENC), prng.getrandbits(ENC) | 1
        out.append(PaillierEncryptionInput(enc_bits=ENC, limb_bits=LIMB, n=n, g=g, m=m, r=r,
                                           res=ref_circuit.paillier_encrypt(n, g, m, r)))
    return out


@pytest.fixture(scope="module")
def pool():
    with SynthPool(B) as kept:
        yield kept


def assert_same(a, b):
    (ta, ia), (tb, ib) = a, b
    for name in TABLE_FIELDS:
        x, y = getattr(ta, name), getattr(tb, name)
        assert x.shape == y.shape and [int(v) for v in x] == [int(v) for v in y], name
    assert len(ia) == len(ib) and all(np.array_equal(x, y) for x, y in zip(ia, ib))


@pytest.mark.parametrize("order", ["given", "reversed"])
def test_each_ciphertext_is_its_own_statements(pool, order):
    inputs = statements()[:: 1 if order == "given" else -1]
    stats = {}
    table, cipher_idx = paillier_enc_batch(inputs, LOOKUP_BITS, pool=pool, stats=stats)
    assert stats["instances"] == B and stats["rows"] == table.n_rows and stats["workers"] > 1
    assert len(cipher_idx) == B
    for inp, idx in zip(inputs, cipher_idx):
        assert idx.dtype == np.int64 and len(idx) == 2 * ENC // LIMB
        assert ref_circuit.recompose(table.values, idx, LIMB) == \
            ref_circuit.paillier_encrypt(inp.n, inp.g, inp.m, inp.r)


def test_kept_pool_own_pool_and_serial_path_agree(pool):
    inputs = statements(11)
    kept, own, serial = {}, {}, {}
    first = paillier_enc_batch(inputs, LOOKUP_BITS, pool=pool, stats=kept)
    assert_same(first, paillier_enc_batch(inputs, LOOKUP_BITS, stats=own, n_workers=B))
    assert_same(first, paillier_enc_batch(inputs, LOOKUP_BITS, stats=serial, n_workers=1))
    again = {}
    assert_same(first, paillier_enc_batch(inputs, LOOKUP_BITS, pool=pool, stats=again))
    for s in (kept, again):
        assert s["spawn_s"] == 0 and s["workers"] > 1 and s["pool_error"] is None
    assert own["spawn_s"] > 0 and own["workers"] > 1
    assert serial["workers"] == 1 and serial["spawn_s"] == 0 and serial["pool_error"] is None
    for s in (kept, own, serial, again):
        assert s["pool_s"] > 0 and s["merge_s"] >= 0 and s["rows"] == first[0].n_rows


def _fails_in_workers(ctx, i, parent_pid):
    """A witness of one cell, which only the parent process can make."""
    if os.getpid() != parent_pid:
        raise RuntimeError("worker down")
    return ctx.load_witness([10 + i])


def test_failed_pool_is_reported_and_not_used_again():
    fn = functools.partial(_fails_in_workers, parent_pid=os.getpid())
    with SynthPool(2) as failing:
        for _ in range(2):
            stats, outputs = {}, []
            table = SinglePhaseCoreManager.synth_parallel(fn, 3, stats=stats, pool=failing,
                                                          outputs=outputs)
            assert "worker down" in stats["pool_error"] and stats["workers"] == 1
            assert failing.error == stats["pool_error"]
            assert [int(v) for v in table.values] == [10, 11, 12]
            assert [list(x) for x in outputs] == [[0], [1], [2]]


def test_outputs_are_rebased_and_none_where_no_cells():
    def tiny(ctx, i):
        ctx.load_witness(list(range(i + 1)))
        return ctx.load_witness([7]) if i != 1 else None

    outputs = []
    table = SinglePhaseCoreManager.synth_parallel(tiny, 3, n_workers=1, outputs=outputs)
    tables = []
    for i in range(3):
        ctx = Context()
        tiny(ctx, i)
        tables.append(ctx.finalize())
    assert row_offsets(tables) == [0, 2, 4]
    assert table.n_rows == merge_tables(tables).n_rows == 8
    assert list(outputs[0]) == [1] and outputs[1] is None and list(outputs[2]) == [7]
    assert int(table.values[7]) == 7


def test_plain_table_check_reads_the_merged_table(pool):
    table, cipher_idx = paillier_enc_batch(statements(13), LOOKUP_BITS, pool=pool)
    assert ref_circuit.violations(table, LOOKUP_BITS) == 0
    low = cipher_idx[B - 1][0]
    table.values[low] = int(table.values[low]) + 1
    assert ref_circuit.violations(table, LOOKUP_BITS) >= 1


def test_a_pool_needs_two_workers():
    with pytest.raises(ValueError, match="at least 2"):
        SynthPool(1)
