"""The PyTorch port's mesh layer (`paillier_halo2_tpu_torch/mesh/`) against
the JAX package's: the four-step NTT in its own output layout, the step-3
twiddles, and the sharded MSM on a 1-D mesh of 8, each on the same inputs;
the 2-D meshes and the batched inverse NTT against the host oracle and the
port's single-device NTT.

A JAX mesh call compiles for seconds on the CPU, so this file makes one for
each JAX mesh module (`mesh.ntt`, `mesh.msm`); the JAX package's tests run
on 8 virtual CPU devices (`tests/conftest.py`), the port's shards all live
on the CPU (`make_mesh(n, "cpu")`), where each shard runs the plain versions
of the kernels.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_halo2_tpu.ec import bn254 as jbn254
from paillier_halo2_tpu.ff import field_jax as fj
from paillier_halo2_tpu.mesh import msm as jmsm
from paillier_halo2_tpu.mesh import ntt as jntt
from paillier_halo2_tpu.mesh import sharding as jsharding
from paillier_halo2_tpu_torch.ec import bn254
from paillier_halo2_tpu_torch.ec import host as ech
from paillier_halo2_tpu_torch.ff import field as f
from paillier_halo2_tpu_torch.ff.host import FR_MOD
from paillier_halo2_tpu_torch.mesh import ntt as mntt
from paillier_halo2_tpu_torch.mesh.msm import msm_sharded_multi
from paillier_halo2_tpu_torch.mesh.sharding import all_to_all, make_mesh, make_mesh_2d, shard_batch
from paillier_halo2_tpu_torch.poly.ntt import ntt


def _fr_values(seed: int, count: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]


def _points(seed: int, n: int):
    rng = random.Random(seed)
    return [ech.g1_mul(ech.G1, rng.randrange(1, ech.R)) for _ in range(n)]


def _scalar_sets(seed: int, n: int, sets: int) -> list[list[int]]:
    rng = random.Random(seed)
    return [[rng.randrange(ech.R) for _ in range(n)] for _ in range(sets)]


def test_ntt_distributed_matches_jax_in_the_four_step_layout():
    """d=2, k=6 (the shape of `tests/test_mesh.py::test_distributed_ntt_2dev`):
    the (digits, d, n2) output before `reorder_output`, then natural order."""
    k, d = 6, 2
    vals = _fr_values(1, 1 << k)
    x = f.to_mont(f.FR, f.pack_ints(vals, "cpu"))
    got = mntt.ntt_distributed(make_mesh(d, "cpu"), x, k)
    xj = fj.to_mont(fj.FR, jnp.asarray(fj.pack_ints(vals)))
    want = np.asarray(jntt.ntt_distributed(jsharding.make_mesh(d), xj, k))
    assert got.shape == (8, d, (1 << k) // d)
    assert torch.equal(got, f.from_ref_digits(want, "cpu"))
    assert torch.equal(mntt.reorder_output(got), ntt(x, k))


@pytest.mark.parametrize("k,d,inverse", [(6, 2, False), (6, 2, True), (8, 4, False), (8, 4, True)])
def test_step3_twiddles_match_jax(k, d, inverse):
    want = jntt._step3_twiddles(k, d, inverse)  # (32, d, n2) Montgomery digits
    assert torch.equal(mntt._step3_twiddles(k, d, inverse), f.from_ref_digits(want, "cpu"))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_distributed_batched_matches_single_device(inverse):
    """d=4, k=8 with a (2, 3) batch: natural order equals `poly.ntt.ntt`."""
    k, d = 8, 4
    x = f.to_mont(f.FR, f.pack_ints(_fr_values(2, 6 << k), "cpu")).reshape(8, 2, 3, 1 << k)
    got = mntt.ntt_natural(make_mesh(d, "cpu"), x, k, inverse)
    assert torch.equal(got, ntt(x, k, inverse))


def test_ntt_distributed_refuses_what_the_four_step_cannot_split():
    x = torch.zeros((8, 1 << 4), dtype=torch.int32)
    for d in (3, 8):  # not a power of two; d^2 = 64 does not divide 16
        with pytest.raises(ValueError):
            mntt.ntt_distributed(make_mesh(d, "cpu"), x, 4)


@pytest.mark.parametrize("split,concat", [(2, 2), (2, 3), (1, 0)])
def test_all_to_all_moves_entry_j_of_shard_i_to_shard_j(split, concat):
    """`jax.lax.all_to_all` without tiling: the output is the input's shape
    without `split`, with the source shard inserted at `concat`."""
    d = 4
    shape = [3, d, d, 5] if split == 2 else [3, d, 5]
    shards = [torch.arange(np.prod(shape)).reshape(shape) + 1000 * i for i in range(d)]
    out = all_to_all(shards, split, concat)
    for j, o in enumerate(out):
        want = torch.stack([s.select(split, j) for s in shards], dim=concat)
        assert torch.equal(o, want)
        for i in range(d):
            assert torch.equal(o.select(concat, i), shards[i].select(split, j))


def test_make_mesh_takes_distinct_cards_or_one_named_device():
    mesh = make_mesh(4, "cpu")
    assert (mesh.size, mesh.shape, mesh.n_cards) == (4, (4,), 0)
    assert [t.shape for t in shard_batch(mesh, torch.zeros((8, 3, 16)))] == [(8, 3, 4)] * 4
    assert make_mesh_2d(2, 4, "cpu").shape == (2, 4)
    if torch.cuda.device_count() >= 2:
        assert make_mesh(2).n_cards == 2
    else:  # "cuda" never puts two shards on one card silently
        with pytest.raises(RuntimeError):
            make_mesh(2)
        with pytest.raises(RuntimeError):
            make_mesh_2d(1, 2)


def test_msm_sharded_multi_matches_jax_on_a_mesh_of_8():
    """n=32 points, window 4, against the JAX package's `msm_sharded_multi`
    on 8 virtual devices (one scalar set: a JAX program per poly count
    compiles for tens of seconds) and the host oracle."""
    n = 32
    pts = _points(3, n)
    sets = _scalar_sets(4, n, 1)
    px, py, pinf = bn254.pack_affine(pts, "cpu")
    sd = torch.stack([f.pack_ints(s, "cpu") for s in sets])
    got = msm_sharded_multi(make_mesh(8, "cpu"), px, py, pinf, sd, window_bits=4)
    jx, jy, jinf = jbn254.pack_affine(pts)
    jsd = jnp.stack([jnp.asarray(fj.pack_ints(s)) for s in sets])
    want = jmsm.msm_sharded_multi(jsharding.make_mesh(8), jx, jy, jinf, jsd, window_bits=4)
    assert got == want == [ech.g1_msm(pts, s) for s in sets]


@pytest.mark.parametrize("n_hosts,chips", [(2, 4), (4, 2)])
def test_msm_2d_mesh_matches_host(n_hosts, chips):
    """The meshes of `tests/test_multihost.py`: chips reduced before hosts."""
    n = 32
    pts = _points(5, n)
    sets = _scalar_sets(6 + n_hosts, n, 2)
    px, py, pinf = bn254.pack_affine(pts, "cpu")
    sd = torch.stack([f.pack_ints(s, "cpu") for s in sets])
    got = msm_sharded_multi(make_mesh_2d(n_hosts, chips, "cpu"), px, py, pinf, sd)
    assert got == [ech.g1_msm(pts, s) for s in sets]
