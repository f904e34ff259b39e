"""The PyTorch port's SRS (`plonk/srs.py`) against the JAX package's: the
k=6 arrays equal `generate_srs` of the JAX package, the comb
(`ec/point_kernels.fixed_base_comb`, on the CPU its plain version) gives the
Jacobian digits of the JAX package's `batched_fixed_base_mul`, and each
package reads the npz cache the other wrote (same name, same digits-first
format).
"""
import os

import numpy as np
import pytest
import torch

from paillier_halo2_tpu.plonk import srs as jsrs
from paillier_halo2_tpu_torch.ec import bn254
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ec import point_kernels as pk
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff.host import FR_MOD
from paillier_halo2_tpu_torch.plonk import srs as tsrs

# pytest-xdist workers share the machine's cores: each worker's torch takes
# its share instead of all of them, so workers do not oversubscribe the CPU.
torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

K = 6
SEED = b"plonk-test"


@pytest.fixture(scope="module")
def pair():
    return tsrs.generate_srs(K, SEED, "cpu"), jsrs.generate_srs(K, SEED)


def _same_srs(t, j) -> bool:
    return (
        t.k == j.k
        and np.array_equal(f.to_ref_digits(t.g1_px), np.asarray(j.g1_px))
        and np.array_equal(f.to_ref_digits(t.g1_py), np.asarray(j.g1_py))
        and np.array_equal(t.g1_inf.cpu().numpy(), np.asarray(j.g1_inf))
        and (t.g2_gen, t.g2_tau) == (j.g2_gen, j.g2_tau)
    )


def test_generate_srs_matches_jax(pair):
    t, j = pair
    assert t.g1_px.dtype == torch.int32 and t.g1_px.shape == (8, 1 << K)
    assert _same_srs(t, j)


def test_srs_points_are_powers_of_tau(pair):
    t, _ = pair
    tau = tsrs._dev_tau(SEED)
    pts = t.g1_points()
    for i in (0, 1, 2, (1 << K) - 1):
        assert pts[i] == ech.g1_mul(ech.G1, pow(tau, i, FR_MOD))
    assert t.g2_tau == ech.g2_mul(ech.G2, tau)


def test_fixed_base_comb_edge_scalars():
    scalars = [0, 1, 2, FR_MOD - 1, 0xDEADBEEF << 200]
    got = bn254.unpack_jacobian(tsrs.batched_fixed_base_mul(scalars, "cpu"))
    assert got == [ech.g1_mul(ech.G1, s % FR_MOD) for s in scalars]


def _comb_scalars() -> list[int]:
    """64 scalars (the k=6 SRS's count, so the JAX comb compiles once): 0, 1,
    r - 1, scalars with zero digits in some windows (every other one, the
    low 31, the high 31), two equal ones, the rest random."""
    rng = np.random.default_rng(9)
    out = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(64)]
    r = out[10]
    out[:9] = [0, 1, FR_MOD - 1, r & int("00ff" * 16, 16), r & (0xFF << 248),
               r & ((1 << 8) - 1), 5 << 128, r, r]
    return out


def test_fixed_base_comb_matches_jax_digits():
    scalars = _comb_scalars()
    want = jsrs.batched_fixed_base_mul(scalars)
    before = dict(pk.LAUNCHES)
    got = tsrs.batched_fixed_base_mul(scalars, "cpu")
    assert dict(pk.LAUNCHES) == before  # no kernel on the CPU
    for t, j in zip(got, want):
        assert np.array_equal(f.to_ref_digits(t), np.asarray(j, np.uint32))
    pts = bn254.unpack_jacobian(got)
    assert pts[0] is None and pts[7] == pts[8] == ech.g1_mul(ech.G1, scalars[7])
    assert pts[2] == ech.g1_neg(ech.G1)


def test_fixed_base_comb_plain_is_the_window_loop():
    """The plain comb adds window w's table row by K3's plain mixed add, w =
    0 .. 31, on standard-form limbs taken as they are: a scalar at or above r
    (here r itself, and 49 * 2^249 - r) reaches the annihilation and the
    doubling branches, which reduced SRS scalars never do."""
    flat = [p for row in tsrs._comb_table() for p in row]
    px, py, pinf = bn254.pack_affine(flat, "cpu")
    table = bn254.pack_points_dense(px, py)
    scalars = [FR_MOD, 49 * (1 << 249) - FR_MOD, 1, 0]
    sd = f.pack_ints(scalars, "cpu")
    got = pk.fixed_base_comb(table, pinf, sd)
    acc = bn254.pack_jacobian([None] * 4, "cpu")
    acc = (bn254.SPEC.limbs("one_mont", "cpu")[:, None].expand(8, 4).contiguous(),) * 2 + (acc[2],)
    for w in range(pk.COMB_WINDOWS):
        d = [(s >> (8 * w)) & 0xFF for s in scalars]
        idx = torch.tensor([w * 256 + x for x in d])
        acc = pk.g1_madd_plain(*acc, px[:, idx], py[:, idx], pinf[idx])
    assert all(torch.equal(g, a) for g, a in zip(got, acc))
    assert bn254.unpack_jacobian(got) == [None, ech.g1_mul(ech.G1, scalars[1]), ech.G1, None]


def test_fixed_base_comb_wrapper_rejects_inputs_it_does_not_take():
    table = torch.zeros((pk.COMB_WINDOWS * pk.COMB_ENTRIES, pk.PACK_WORDS), dtype=torch.int32)
    inf = torch.ones(pk.COMB_WINDOWS * pk.COMB_ENTRIES, dtype=torch.bool)
    sd = f.pack_ints([3, 4], "cpu")
    assert pk.fixed_base_comb(table, inf, sd)[2].shape == (8, 2)
    with pytest.raises(TypeError):
        pk.fixed_base_comb(table, inf, sd.to(torch.int64))
    with pytest.raises(ValueError):
        pk.fixed_base_comb(table[:-1], inf, sd)
    with pytest.raises(ValueError):
        pk.fixed_base_comb(table, inf.to(torch.int32), sd)
    with pytest.raises(ValueError):
        pk.fixed_base_comb(table, inf, sd[:4])
    with pytest.raises(ValueError):
        pk.fixed_base_comb(table, inf, sd.to("meta"))


def test_caches_cross_load(pair, tmp_path, monkeypatch):
    t, j = pair
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    # the port writes, the JAX package reads
    written = tsrs.read_or_create_srs(K, SEED, "cpu", str(port_dir))
    assert _same_srs(written, j)
    assert (port_dir / f"kzg_bn254_dev_{K}.npz").exists()
    monkeypatch.setattr(jsrs, "PARAMS_DIR", str(port_dir))
    assert _same_srs(t, jsrs.read_or_create_srs(K))
    # the JAX package writes, the port reads
    monkeypatch.setattr(jsrs, "PARAMS_DIR", str(jax_dir))
    jsrs.read_or_create_srs(K, SEED)
    assert _same_srs(tsrs.read_or_create_srs(K, b"ignored", "cpu", str(jax_dir)), j)
