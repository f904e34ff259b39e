"""The PyTorch port's copied host layer against the JAX package's: circuit
synthesis (`gadgets/`, `harness/circuits.py`), column layout
(`plonk/layout.py`), the transcript (`plonk/transcript.py`) and the big-uint
host helpers (`bignum/host.py`).

Both packages synthesize the same circuits from the same seeded inputs; the
finalized `VirtualTable` arrays and the layouts must be equal array for
array.
"""
import random

import numpy as np
import pytest

from paillier_halo2_tpu.bignum import host as jbh
from paillier_halo2_tpu.gadgets.context import Context as JContext
from paillier_halo2_tpu.gadgets.context import merge_tables as jmerge_tables
from paillier_halo2_tpu.gadgets.range import RangeChip as JRangeChip
from paillier_halo2_tpu.harness import circuits as jcirc
from paillier_halo2_tpu.plonk import layout as jlayout
from paillier_halo2_tpu.plonk import transcript as jtr
from paillier_halo2_tpu_torch.bignum import host as tbh
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.gadgets.context import Context, merge_tables
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness import circuits as tcirc
from paillier_halo2_tpu_torch.plonk import layout as tlayout
from paillier_halo2_tpu_torch.plonk import transcript as ttr

TABLE_FIELDS = ("values", "gates", "copy_a", "copy_b", "const_idx", "const_val", "lookups", "publics")
# (circuit, enc_bits, limb_bits, k, lookup_bits): the K=10 slice circuit, the
# add circuit, an odd geometry and the main path's ENC=128/LIMB=64 circuit
GEOMETRIES = [
    ("enc", 16, 8, 10, 9), ("add", 16, 8, 10, 9), ("enc", 40, 13, 11, 10), ("enc", 128, 64, 14, 13),
]


def _tables(kind, enc, limb, lookup_bits, seed=3):
    prng = random.Random(seed)
    n = prng.getrandbits(enc) | (1 << (enc - 1)) | 1
    a, b, c = (prng.getrandbits(enc) for _ in range(3))
    out = []
    for circ, bh, ctx_cls, rc_cls in (
        (tcirc, tbh, Context, RangeChip), (jcirc, jbh, JContext, JRangeChip),
    ):
        ctx = ctx_cls()
        if kind == "enc":
            inp = circ.PaillierEncryptionInput(enc, limb, n, a, b, c, bh.paillier_enc_native(n, a, b, c))
            circ.paillier_enc_test(ctx, rc_cls(ctx, lookup_bits), inp)
        else:
            inp = circ.PaillierAddCipherInput(limb, enc, n, a, b, c, bh.paillier_add_native(n, b, c))
            circ.paillier_enc_add_test(ctx, rc_cls(ctx, lookup_bits), inp)
        out.append(ctx.finalize())
    return out


@pytest.mark.parametrize("kind,enc,limb,k,lookup_bits", GEOMETRIES)
def test_finalized_tables_match_jax(kind, enc, limb, k, lookup_bits):
    t, j = _tables(kind, enc, limb, lookup_bits)
    for name in TABLE_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert t.n_rows == j.n_rows and t.public_values() == j.public_values()


@pytest.mark.parametrize("kind,enc,limb,k,lookup_bits", GEOMETRIES)
def test_layouts_match_jax(kind, enc, limb, k, lookup_bits):
    t, j = _tables(kind, enc, limb, lookup_bits)
    lt, lj = tlayout.assign_layout(t, k, lookup_bits), jlayout.assign_layout(j, k, lookup_bits)
    assert (lt.num_advice, lt.num_lookup_advice, lt.n_perm_cols) == (
        lj.num_advice, lj.num_lookup_advice, lj.n_perm_cols,
    )
    for name in ("col_of", "row_of", "q", "fixed_const", "sigma_col", "sigma_row", "lookup_src"):
        assert np.array_equal(getattr(lt, name), getattr(lj, name)), name
    assert np.array_equal(tlayout.witness_columns(t, lt, b"s"), jlayout.witness_columns(j, lj, b"s"))
    assert np.array_equal(tlayout.lookup_columns(t, lt), jlayout.lookup_columns(j, lj))


def _public_table(ctx_cls, rc_cls, seed):
    """Range-checked products of witnesses, two of them exposed publicly."""
    prng = random.Random(seed)
    ctx = ctx_cls()
    rc = rc_cls(ctx, 6)
    prod = rc.gate.mul(ctx.load_witness([prng.randrange(1, 7) for _ in range(4)]),
                       ctx.load_witness([prng.randrange(1, 7) for _ in range(4)]))
    rc.range_check(prod, 6)
    ctx.expose_public(prod[1:3])
    return ctx.finalize()


def test_merged_tables_with_publics_match_jax():
    """The witness pool's merge (`merge_tables`) of three tables with public
    cells, against the JAX package's: every row index rebased by the rows
    before it, the public cells kept in table order."""
    t = merge_tables([_public_table(Context, RangeChip, s) for s in (1, 2, 3)])
    j = jmerge_tables([_public_table(JContext, JRangeChip, s) for s in (1, 2, 3)])
    for name in TABLE_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    parts = [_public_table(Context, RangeChip, s) for s in (1, 2, 3)]
    assert t.n_rows == j.n_rows == sum(x.n_rows for x in parts)
    assert t.public_values() == j.public_values() == [v for x in parts for v in x.public_values()]
    assert len(t.public_values()) == 6

def test_transcripts_match_jax():
    prng = random.Random(9)
    pts = [ech.g1_mul(ech.G1, prng.randrange(1, ech.R)) for _ in range(4)]
    scalars = [0, 1, ech.R - 1, prng.randrange(ech.R)]
    writers = (ttr.TranscriptWriter(), jtr.TranscriptWriter())
    challenges = ([], [])
    for w, ch in zip(writers, challenges):
        w.common_point(pts[1])
        w.common_scalar(scalars[3])
        for p, s in zip(pts, scalars):
            w.write_point(p)
            w.write_scalar(s)
            ch.append(w.squeeze_challenge())
    proof = writers[0].finalize()
    assert proof == writers[1].finalize() and challenges[0] == challenges[1]
    rd = ttr.TranscriptReader(proof)
    rd.common_point(pts[1])
    rd.common_scalar(scalars[3])
    for p, s, c in zip(pts, scalars, challenges[0]):
        assert (rd.read_point(), rd.read_scalar(), rd.squeeze_challenge()) == (p, s, c)
    rd.assert_consumed()
    assert all(ttr.point_from_bytes(ttr.point_to_bytes(p)) == p for p in pts)
    for w in (ttr.TranscriptWriter(), jtr.TranscriptWriter()):
        with pytest.raises(ValueError):  # both refuse to absorb infinity
            w.write_point(None)


def test_bignum_host_matches_jax():
    prng = random.Random(4)
    v = prng.getrandbits(200)
    assert tbh.decompose(v, 4, 64) == jbh.decompose(v, 4, 64)
    assert tbh.recompose(tbh.decompose(v, 4, 64), 64) == v
    arr = np.array([prng.getrandbits(90) for _ in range(5)], dtype=object)
    assert np.array_equal(tbh.decompose_array(arr, 3, 32), jbh.decompose_array(arr, 3, 32))
    n = prng.getrandbits(64) | 1
    assert tbh.paillier_enc_native(n, 5, 7, 11) == jbh.paillier_enc_native(n, 5, 7, 11)
    assert tbh.paillier_add_native(n, 5, 7) == 35 % (n * n)
