"""Sharded MSM: bases and scalars split across the mesh's shards, bucket
accumulation on each shard, the bucket sets combined across shards, then
one window-sum pass and the host's Horner step.

Counterpart of `paillier_halo2_tpu/mesh/msm.py:63-180`. Each shard runs
`msm.pippenger._bucket_accumulate` on its slice of the point axis, with the
route the single-device MSM takes on that device (signed windows through
the lazy bucket-loop and merge kernels on the card, unsigned windows on the
CPU) and the window and sub-accumulator schedule of the PER-SHARD point
count. On the signed route polys go in groups of at most `MAX_LANES`
bucket lanes a shard, the same groups on every shard, so that bucket sets
line up.

The bucket sets meet on `mesh.devices[0]` and are combined by a pairwise
tree of full point adds (`ec.bn254.padd`, K2 on the card): two shards can
hold equal bucket sums, or infinity, so the add must take the doubling
branch. The tree halves the shard axis each level, adding entry i to entry
i + m/2, which for a power of two is the JAX package's roll-and-add fold
(`mesh/msm.py:128-141`); an odd entry out waits for the next level. On a
2-D mesh the "chip" axis is reduced before the "host" axis. Then one
`_window_sums` launch and the host Horner step, as in `msm_packed_multi`.

The JAX package caches its per-shard program with `functools.lru_cache`
under a key that omits `PAILLIER_TPU_LAZY` (`mesh/msm.py:19`); the port
runs eagerly and caches nothing here.
"""
from __future__ import annotations

import torch

from ..ec import bn254
from ..ec import host as ech
from ..msm import pippenger as pip
from .sharding import Mesh, gather, on, shard_batch

N_LIMBS = 8


def _unsigned_window_bits(n: int) -> int:
    """The unsigned route's window for n points a shard: 4 below 2^13, 8
    from there. A call's bucket adds grow as n * 256 / c, its merge and
    window sums as 2^c * 256 / c, so small shards want small windows: on an
    8-core x86 CPU the distributed K=10 keygen and proof of two Paillier
    additions over 4 shards took 53 s at window 4 and 108 s at window 8
    (the JAX package's tests also commit at window 4,
    `tests/conftest.py:53`)."""
    return 4 if n < 1 << 13 else 8


def _tree_reduce_axis(p: bn254.JPoint, axis: int) -> bn254.JPoint:
    """Sum along one axis of Jacobian tensors by a halving tree of full
    adds; the axis is left with length 1."""
    while p[0].shape[axis] > 1:
        m = p[0].shape[axis]
        half = m // 2
        s = bn254.padd(tuple(c.narrow(axis, 0, half) for c in p),
                       tuple(c.narrow(axis, half, half) for c in p))
        if m % 2:
            s = tuple(torch.cat([sc, c.narrow(axis, m - 1, 1)], dim=axis) for sc, c in zip(s, p))
        p = s
    return p


def combine_buckets(mesh: Mesh, local: list[bn254.JPoint]) -> bn254.JPoint:
    """The shards' bucket sets (each coordinate (8, rows, B)) summed on
    `mesh.devices[0]`, the mesh's minor axis first."""
    tail = tuple(local[0][0].shape[1:])
    p = tuple(gather([b[i] for b in local], mesh.devices[0], 1).reshape(
        (N_LIMBS,) + mesh.shape + tail) for i in range(3))
    for axis in range(len(mesh.shape), 0, -1):
        p = _tree_reduce_axis(p, axis)
    return tuple(c.reshape((N_LIMBS,) + tail) for c in p)


def msm_sharded_multi(mesh: Mesh, px, py, p_inf, scalars,
                      window_bits: int | None = None) -> list[ech.Point]:
    """Batched MSMs sharing one base set, the point axis split across the
    mesh: bases as `msm_packed_multi` takes them, scalars (P, 8, N)
    standard-form limbs (each below r on the card), P host affine points
    back. N must be a multiple of the mesh size; the route follows the
    bases' device as on one device, and `window_bits` defaults to
    `_signed_window_bits(N / d)` on the card, `_unsigned_window_bits(N / d)`
    on the CPU."""
    assert scalars.dim() == 3
    n_polys, n = scalars.shape[0], scalars.shape[2]
    d = mesh.size
    if n % d:
        raise ValueError(f"{n} points do not split into {d} shards; pad to a multiple")
    n_local = n // d
    s_base, s_cap = pip.default_schedule(px.device)
    if px.device.type == "cuda":
        c = window_bits or pip._signed_window_bits(n_local)
        n_buckets, n_windows, subs, bcaps, group = pip._signed_plan(scalars, c, s_base)
        if n_polys > group:
            out = []
            for i in range(0, n_polys, group):
                out.extend(msm_sharded_multi(mesh, px, py, p_inf, scalars[i : i + group], c))
            return out
        keys, neg = pip._signed_keys(scalars, c)  # (P, W, N) each
        neg_shards = shard_batch(mesh, neg.reshape(n_polys * n_windows, n))
        subs_all, bcaps_all = subs * n_polys, bcaps * n_polys
    else:
        c = window_bits or _unsigned_window_bits(n_local)
        keys = pip._keys_from_digits(scalars, c)  # (P, W, N)
        n_windows = keys.shape[1]
        n_buckets = 1 << c
        subs_all = pip._sub_schedule(n_windows, c, s_base, s_cap) * n_polys  # row = p*W + w
        bcaps_all, neg_shards = None, [None] * d
    key_shards = shard_batch(mesh, keys.reshape(n_polys * n_windows, n))
    local = []
    for dev, x, y, inf, key, neg in zip(mesh.devices, shard_batch(mesh, px), shard_batch(mesh, py),
                                       shard_batch(mesh, p_inf), key_shards, neg_shards):
        with on(dev):
            local.append(pip._bucket_accumulate(x, y, inf, key, n_buckets, subs_all, bcaps_all,
                                                neg))
    with on(mesh.devices[0]):
        buckets = combine_buckets(mesh, local)
        return pip._horner(pip._window_sums(buckets, n_buckets), n_polys, n_windows, c)


def msm_sharded(mesh: Mesh, px, py, p_inf, scalar_limbs,
                window_bits: int | None = None) -> ech.Point:
    """One sharded MSM over (8, N) standard-form scalar limbs."""
    return msm_sharded_multi(mesh, px, py, p_inf, scalar_limbs[None], window_bits)[0]
