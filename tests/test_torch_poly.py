"""The PyTorch port's polynomial layer (`poly/ntt.py`, `poly/ops.py`) against
the JAX package: the NTT against its Python oracle `poly/ntt.py::ntt_host`,
and every `poly/ops` function against its JAX counterpart at k <= 8.

Inputs are random Fr values from a numpy seed (plus zeros and p-1); every
comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from paillier_halo2_tpu.poly import ntt as jntt
from paillier_halo2_tpu.poly import ops as jops
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff import host
from paillier_halo2_tpu_torch.poly import ops
from paillier_halo2_tpu_torch.poly.domain import Domain
from paillier_halo2_tpu_torch.poly.ntt import ntt, ntt_host

P = host.FR_MOD


def _vals(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    flat = [int.from_bytes(w.astype(np.uint32).tobytes(), "little") % P for w in words]
    flat[:2] = [0, P - 1]
    return np.array(flat, dtype=object).reshape(shape)


def _same(t, j) -> bool:
    return np.array_equal(f.to_ref_digits(t), np.asarray(j, dtype=np.uint32))


def _mont_pair(vals):
    """Host values -> (port Montgomery tensor, JAX Montgomery digits)."""
    return ops.to_device_mont(vals, "cpu"), jops.to_device_mont(vals)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_ntt_host(k, inverse):
    vals = _vals(k, (1 << k,))
    got = ops.from_device_mont(ntt(ops.to_device_mont(vals, "cpu"), k, inverse))
    want = ntt_host(list(vals), k, inverse)
    assert got == want == jntt.ntt_host(list(vals), k, inverse)


def test_ntt_batched_rows_and_round_trip():
    k = 6
    vals = _vals(7, (3, 1 << k))
    x = ops.to_device_mont(vals, "cpu")
    fwd = ntt(x, k)
    for row in range(3):
        assert ops.from_device_mont(fwd[:, row]) == ntt_host(list(vals[row]), k)
    assert ops.from_device_mont(ntt(fwd, k, inverse=True)) == list(vals.reshape(-1))


@pytest.mark.parametrize("which", ["coeffs_of", "values_of"])
def test_coeffs_values_match_ops(which):
    k = 6
    x_t, x_j = _mont_pair(_vals(3, (2, 1 << k)))
    assert _same(getattr(ops, which)(x_t, k), getattr(jops, which)(x_j, k))


def test_extended_coset_round_trip_matches_ops():
    k, k_ext = 3, 5
    c_t, c_j = _mont_pair(_vals(4, (2, 1 << k)))
    ext_t = ops.extended_coset_evals(c_t, k, k_ext)
    ext_j = jops.extended_coset_evals(c_j, k, k_ext)
    assert _same(ext_t, ext_j)
    back_t = ops.coeffs_from_extended(ext_t, k, k_ext)
    assert _same(back_t, jops.coeffs_from_extended(ext_j, k, k_ext))
    assert _same(back_t[..., : 1 << k], c_j) and not back_t[..., 1 << k :].any()


@pytest.mark.parametrize("fn", ["prefix_product", "batch_inverse", "_suffix_sum"])
def test_scans_match_ops(fn):
    vals = _vals(5, (2, 37))
    vals[vals == 0] = 3  # batch_inverse takes nonzero values
    x_t, x_j = _mont_pair(vals)
    assert _same(getattr(ops, fn)(x_t), getattr(jops, fn)(x_j))


@pytest.mark.parametrize("axis", [1, 2])
def test_sum_axis_matches_ops(axis):
    x_t, x_j = _mont_pair(_vals(6, (5, 7)))
    assert _same(ops.sum_axis(x_t, axis), jops.sum_axis(x_j, axis))


def test_powers_dev_matches_ops():
    xs = [5, P - 1, 123456789]
    assert _same(ops.powers_dev(xs, 16, "cpu"), jops.powers_dev(xs, 16))


@pytest.mark.parametrize("z", [0, 7, P - 2])
def test_eval_and_synthetic_divide_match_ops(z):
    c_t, c_j = _mont_pair(_vals(8, (32,)))
    assert ops.eval_at(c_t, z) == jops.eval_at(c_j, z)
    q_t = ops.synthetic_divide(c_t, z)
    assert _same(q_t, jops.synthetic_divide(c_j, z))
    # (f(X) - f(z)) = q(X) (X - z), checked at a host point
    cs, qs, x = ops.from_device_mont(c_t), ops.from_device_mont(q_t), 99
    ev = lambda coeffs, at: sum(c * pow(at, i, P) for i, c in enumerate(coeffs)) % P  # noqa: E731
    assert (ev(cs, x) - ev(cs, z)) % P == ev(qs, x) * (x - z) % P


def test_packing_and_transfer_counts():
    vals = _vals(9, (3, 4))
    vals[0, 0] = 5  # the small-value path and the big-value path
    assert np.array_equal(f.to_ref_digits(ops.pack_values(vals, "cpu")), jops.pack_values(vals))
    small = np.arange(12, dtype=object).reshape(3, 4)
    assert np.array_equal(f.to_ref_digits(ops.pack_values(small, "cpu")), jops.pack_values(small))
    assert _same(ops.fr_digits_mont(12345, "cpu")[:, None], jops.fr_digits_mont(12345)[:, None])
    ops.reset_transfer_counts()
    t = ops.to_device_mont(vals, "cpu")
    assert ops.from_device_mont(t) == list(vals.reshape(-1))
    assert ops.reset_transfer_counts() == {"h2d": 1, "d2h": 1}


def test_domain_constants():
    d = Domain(10)
    assert (d.n, d.k_ext, d.n_ext) == (1024, 12, 4096)
    assert pow(d.omega, d.n, P) == 1 and pow(d.omega, d.n // 2, P) != 1
    assert d.omega * d.omega_inv % P == 1
    assert pow(d.omega_ext, 4, P) == d.omega
    assert d.powers(d.omega, 3) == [1, d.omega, d.omega * d.omega % P]
