"""keygen's fixed columns in the PyTorch port (`plonk/keygen.py`), formed on
the key's device from the layout's integer arrays: every coefficient column
and every verifying-key commitment equals a frozen copy of the construction
they replace, which built each column as Python ints (sigma as
delta^col * omega^row mod P one cell at a time) and packed every cell with
`to_bytes`. Also `keygen.FIXED_CELLS`: one keygen counts every fixed cell
but the constant column's as formed on the device, and the constant column
as packed from Python ints.

Tables: the K=10 fixture's encryption (`torch_fixtures/slice_enc_k10.json`),
the instance fixture's statement (`torch_fixtures/instance_enc_k10.json`, an
instance column), and a range check beside constants past 2^63 (whose
column takes `ops.pack_values`' byte path) at `dist_add_k10.json`'s K and
SRS; on the CPU.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from paillier_halo2_tpu_torch.bignum.host import paillier_enc_native
from paillier_halo2_tpu_torch.ff import host
from paillier_halo2_tpu_torch.gadgets import (
    BigUintChip,
    Context,
    EncryptionPublicKeyAssigned,
    PaillierChip,
)
from paillier_halo2_tpu_torch.gadgets.range import RangeChip
from paillier_halo2_tpu_torch.harness.circuits import PaillierEncryptionInput, paillier_enc_test
from paillier_halo2_tpu_torch.plonk import keygen as kg
from paillier_halo2_tpu_torch.plonk.kzg import commit_many
from paillier_halo2_tpu_torch.plonk.layout import assign_layout
from paillier_halo2_tpu_torch.plonk.params import BLINDING_ROWS
from paillier_halo2_tpu_torch.plonk.srs import generate_srs
from paillier_halo2_tpu_torch.poly import ops

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
P = host.FR_MOD


def _enc_table(fx):
    inp = PaillierEncryptionInput(enc_bits=fx["enc_bits"], limb_bits=fx["limb_bits"], **fx["inputs"])
    ctx = Context()
    paillier_enc_test(ctx, RangeChip(ctx, fx["lookup_bits"]), inp)
    return ctx.finalize()


def _instance_table(fx):
    """`tests/test_torch_instance.py`'s statement: the encryption, then n, g
    and the ciphertext limbs exposed."""
    enc, limb = fx["enc_bits"], fx["limb_bits"]
    x = fx["inputs"]
    assert x["res"] == paillier_enc_native(x["n"], x["g"], x["m"], x["r"])
    ctx = Context()
    bu = BigUintChip(RangeChip(ctx, fx["lookup_bits"]), limb)
    pc = PaillierChip.construct(bu, enc)
    n_a, g_a = bu.assign_integer(x["n"], enc), bu.assign_integer(x["g"], enc)
    c = pc.encrypt(EncryptionPublicKeyAssigned(n_a, g_a), bu.assign_integer(x["m"], enc),
                   bu.assign_integer(x["r"], enc))
    res_a = bu.assign_integer(x["res"], enc * 2)
    bu.assert_equal_fresh(c, res_a)
    for cells in (n_a.limbs, g_a.limbs, res_a.limbs):
        ctx.expose_public(cells)
    return ctx.finalize()


def _big_constant_table(fx):
    ctx = Context()
    RangeChip(ctx, fx["lookup_bits"]).range_check(ctx.load_witness([3, 200, 40000]), 16)
    ctx.load_constants([P - 1, (1 << 200) + 5, 1 << 63, 7])
    return ctx.finalize()


def _object_int_columns(layout, k: int, lookup_bits: int) -> np.ndarray:
    """Frozen copy of the fixed columns as keygen built them before they were
    formed on the device: (m, n) object ints in the key's column order."""
    n = 1 << k
    usable = n - BLINDING_ROWS
    na = layout.num_advice
    q_vals = [layout.q[c].astype(object) for c in range(na)]
    table_vals = np.zeros(n, dtype=object)
    table_vals[: 1 << lookup_bits] = np.arange(1 << lookup_bits).astype(object)
    w = host.root_of_unity(k)
    omega_arr = np.array([pow(w, r, P) for r in range(n)], dtype=object)
    delta_arr = np.array([pow(kg.DELTA, j, P) for j in range(layout.n_perm_cols)], dtype=object)
    sigma_values = delta_arr[layout.sigma_col] * omega_arr[layout.sigma_row] % P
    active_vals = np.zeros(n, dtype=object)
    active_vals[:usable] = 1
    l0_vals = np.zeros(n, dtype=object)
    l0_vals[0] = 1
    lu_vals = np.zeros(n, dtype=object)
    lu_vals[usable] = 1
    return np.stack(q_vals + [layout.fixed_const, table_vals] + list(sigma_values)
                    + [active_vals, l0_vals, lu_vals])


@pytest.fixture(scope="module", params=[("slice_enc_k10.json", _enc_table),
                                        ("instance_enc_k10.json", _instance_table),
                                        ("dist_add_k10.json", _big_constant_table)],
                ids=["enc", "instance", "big_constants"])
def keyed(request):
    """(fixture, table, srs, the FIXED_CELLS difference of one keygen, pk)."""
    name, build = request.param
    fx = json.loads((FIXTURES / name).read_text())
    table = build(fx)
    srs = generate_srs(fx["k"], fx["srs_seed"].encode(), "cpu")
    before = dict(kg.FIXED_CELLS)
    pk = kg.keygen(table, fx["k"], fx["lookup_bits"], srs)
    cells = {key: kg.FIXED_CELLS[key] - before[key] for key in before}
    return fx, table, srs, cells, pk


def _key_columns(pk) -> list[torch.Tensor]:
    return (pk.q_coeffs + [pk.fixed_const_coeffs, pk.table_coeffs] + pk.sigma_coeffs
            + [pk.active_coeffs, pk.l0_coeffs, pk.lu_coeffs])


def test_fixed_coefficients_and_commitments_equal_the_object_int_construction(keyed, request):
    fx, table, srs, _, pk = keyed
    k, lookup_bits = fx["k"], fx["lookup_bits"]
    layout = assign_layout(table, k, lookup_bits)
    want = ops.coeffs_of(ops.to_device_mont(_object_int_columns(layout, k, lookup_bits), "cpu"), k)
    got = _key_columns(pk)
    assert want.shape[1] == len(got)
    for i, col in enumerate(got):
        assert torch.equal(col, want[:, i]), i
    n_committed = len(pk.vk.fixed_commitments())
    assert commit_many(srs, [want[:, i] for i in range(n_committed)]) == pk.vk.fixed_commitments()
    assert list(pk.table_values) == list(np.arange(1 << lookup_bits)) + [0] * ((1 << k) - (1 << lookup_bits))
    assert list(pk.fixed_const_values) == list(layout.fixed_const)
    if request.node.callspec.id == "big_constants":
        assert max(layout.fixed_const) == P - 1


def test_fixed_cells_counts_the_constant_column_as_host_ints(keyed):
    fx, _, _, cells, pk = keyed
    n = 1 << fx["k"]
    assert pk.vk.num_instance == ("publics" in fx)
    n_fixed = len(_key_columns(pk)) * n
    assert cells == {"device": n_fixed - n, "host_ints": n}
    assert cells["device"] == (pk.vk.num_advice + 4 + pk.vk.n_perm_cols) * n
