"""The port's native CPU NTT route (`native.fr_ntt`, `poly/ops.py`
`_ntt_any`) against the port's torch NTT and the JAX package's Python
oracle `poly/ntt.py::ntt_host`, and the route each `ntt_backend` takes.

Inputs are random Fr values from a numpy seed (plus zeros and p-1), in
Montgomery form as the prover holds them; every comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

from paillier_halo2_tpu.poly.ntt import ntt_host as jax_ntt_host
from paillier_halo2_tpu_torch import native
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import host
from paillier_halo2_tpu_torch.mesh.sharding import make_mesh
from paillier_halo2_tpu_torch.poly import ops
from paillier_halo2_tpu_torch.poly.ntt import ntt

torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

P = host.FR_MOD
R = f.FR.r_mod_p


def _vals(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    flat = [int.from_bytes(w.astype(np.uint32).tobytes(), "little") % P for w in words]
    flat[:2] = [0, P - 1]
    return np.array(flat, dtype=object).reshape(shape)


def _mont(vals: np.ndarray) -> torch.Tensor:
    """(8, *shape) Montgomery limbs of an object array of Fr values."""
    flat = [int(v) * R % P for v in vals.reshape(-1)]
    return f.pack_ints(flat, "cpu").reshape((8,) + vals.shape)


@pytest.mark.parametrize("batch", [(), (3,), (2, 5)], ids=["8xn", "8x3xn", "8x2x5xn"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("k", [1, 4, 10])
def test_native_ntt_equals_torch_and_jax_oracle(k, inverse, batch):
    n = 1 << k
    vals = _vals(100 * k + len(batch) + int(inverse), batch + (n,))
    x = _mont(vals)
    with ops.ntt_backend("native"):
        got = ops.coeffs_of(x, k) if inverse else ops.values_of(x, k)
    assert got.shape == x.shape and got.dtype == torch.int32
    assert torch.equal(got, ntt(x, k, inverse))
    want = [jax_ntt_host([int(v) for v in row], k, inverse) for row in vals.reshape(-1, n)]
    assert f.unpack_ints(f.from_mont(f.FR, got)) == [v for row in want for v in row]


def test_fr_ntt_rejects_wrong_arrays():
    k, n = 3, 8
    good = np.zeros((2, n, 32), np.uint8)
    native.fr_ntt(good, k, False)  # all zeros stay zeros
    assert not good.any()
    for bad in (np.zeros((2, n, 8), np.uint32), np.zeros((2, n, 16), np.uint8),
                np.zeros((2, 2 * n, 32), np.uint8), np.zeros((2, 32, n), np.uint8).transpose(0, 2, 1),
                np.zeros(n * 32, np.uint8)):
        with pytest.raises(ValueError):
            native.fr_ntt(bad, k, False)


def test_ntt_backend_routes_are_counted():
    k = 4
    x = _mont(_vals(7, (2, 1 << k)))
    ops.reset_ntt_routes()
    outs = {}
    for backend in ("torch", "native", "auto"):
        with ops.ntt_backend(backend):
            outs[backend] = ops.values_of(x, k)
    assert ops.NTT_ROUTES == {"mesh": 0, "native": 2, "torch": 1}
    assert torch.equal(outs["torch"], outs["native"]) and torch.equal(outs["torch"], outs["auto"])
    with ops.proving_mesh(make_mesh(2, "cpu")), ops.ntt_backend("native"):
        assert torch.equal(ops.values_of(x, k), outs["torch"])  # the mesh route comes first
    assert ops.reset_ntt_routes() == {"mesh": 1, "native": 2, "torch": 1}
    assert ops.NTT_ROUTES == {"mesh": 0, "native": 0, "torch": 0}
    with pytest.raises(ValueError, match="unknown NTT backend"):
        ops.ntt_backend("device")


def test_native_backend_without_the_library(monkeypatch):
    """Without the library "auto" takes the torch NTT and "native" raises."""
    k = 3
    x = _mont(_vals(9, (1 << k,)))
    monkeypatch.setattr(native, "lib", lambda: None)
    ops.reset_ntt_routes()
    assert torch.equal(ops.values_of(x, k), ntt(x, k))
    assert ops.NTT_ROUTES["torch"] == 1 and ops.NTT_ROUTES["native"] == 0
    with ops.ntt_backend("native"), pytest.raises(ValueError, match="did not build"):
        ops.values_of(x, k)
