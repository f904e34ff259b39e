"""The PyTorch port's SRS (`plonk/srs.py`) against the JAX package's: the
k=6 arrays equal `generate_srs` of the JAX package, and each package reads
the npz cache the other wrote (same name, same digits-first format).
"""
import os

import numpy as np
import pytest
import torch

from paillier_halo2_tpu.plonk import srs as jsrs
from paillier_halo2_tpu_torch.ec import bn254
from paillier_halo2_tpu_torch.ec import host as ech
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
