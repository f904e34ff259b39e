"""Distributed four-step NTT: local butterfly stages per shard, the global
stages through two all-to-all transposes.

Counterpart of `paillier_halo2_tpu/mesh/ntt.py:1`. Bailey's decomposition
with n1 = d (the mesh size) and n2 = N/d: the input A[j1, j2] = a[j1*n2 + j2]
is row-major sharded by j1 (`shard_batch`), and with m = n2/d:

  1. all-to-all: shard q holds every j1 for j2 in [q*m, (q+1)*m);
  2. length-d NTTs over j1 (root w_N^{n2}), giving k1;
  3. times w_N^{k1*j2}, the twiddles of shard q's j2 chunk;
  4. all-to-all: shard k1 holds the whole j2 row for its k1;
  5. a length-n2 NTT over j2 (root w_N^d), giving k2.

Index maths of step 4: after step 3 shard p holds B_p[k1, l] for
j2 = p*m + l. `all_to_all(split 2, concat 2)` gives shard k1 the entries
[p, l] = B_p[k1, l], so flattening (p, l) lists j2 = p*m + l in order.
(`jax.lax.all_to_all(split 2, concat 3)`, which the JAX package takes, puts
p last and swaps the axes back.) Shard k1 then holds
X[k2*d + k1] at [k2]: the output is (8, *batch, d, n2) with X[k2*d + k1] at
[k1, k2], the JAX package's layout; `reorder_output` gives natural order.

Each local sub-NTT is `poly.ntt.ntt` on that shard's device, its products
K1; the inverse takes w^-1 and the two inverse sub-NTTs scale by 1/d and
1/n2, which is 1/n. Middle (batch) axes ride through every stage. The
caller's tensor is split across the mesh before the transform and the
result gathered on `mesh.devices[0]` after it.
"""
from __future__ import annotations

import functools

import torch

from ..ff import field as f
from ..ff import host
from ..poly.ntt import ntt
from .sharding import Mesh, all_to_all, gather, on, shard_batch

N_LIMBS = 8
PRIME = host.FR_MOD


@functools.lru_cache(maxsize=None)
def _step3_values(k: int, d: int, inverse: bool) -> tuple[int, ...]:
    """w_N^{±k1*j2} in Montgomery form, k1-major: (d, n2) flattened."""
    n2 = (1 << k) // d
    w = host.root_of_unity(k)
    if inverse:
        w = pow(w, PRIME - 2, PRIME)
    vals = []
    for k1 in range(d):
        wk1 = pow(w, k1, PRIME)
        acc = f.FR.r_mod_p
        for _ in range(n2):
            vals.append(acc)
            acc = acc * wk1 % PRIME
    return tuple(vals)


def _step3_twiddles(k: int, d: int, inverse: bool) -> torch.Tensor:
    """(8, d, n2) Montgomery limbs of w_N^{±k1*j2} on the CPU (the JAX
    package's `_step3_twiddles`, as 32-bit limbs instead of 8-bit digits)."""
    return f.pack_ints(_step3_values(k, d, inverse), "cpu").reshape(N_LIMBS, d, -1)


@functools.lru_cache(maxsize=64)
def _twiddle_shards(k: int, inverse: bool, devices: tuple) -> tuple[torch.Tensor, ...]:
    """Shard q's (8, d, m) block of the step-3 twiddles: every k1, its j2 chunk."""
    d = len(devices)
    tw = _step3_twiddles(k, d, inverse)
    return tuple(shard_batch(Mesh(devices, (d,), ("x",)), tw))


def ntt_distributed(mesh: Mesh, x: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """NTT of an (8, *batch, 2^k) Montgomery tensor over the mesh's shards;
    returns (8, *batch, d, n2) in the four-step layout on `mesh.devices[0]`
    (`reorder_output` gives natural order). Needs d a power of two and
    d^2 | 2^k."""
    d = mesh.size
    n = 1 << k
    k1_bits = d.bit_length() - 1
    if 1 << k1_bits != d or n % (d * d):
        raise ValueError(f"the four-step NTT needs d a power of two and d^2 | n (d={d}, n={n})")
    if x.shape[0] != N_LIMBS or x.shape[-1] != n:
        raise ValueError(f"expected (8, ..., {n}), got {tuple(x.shape)}")
    n2 = n // d
    m = n2 // d
    batch = tuple(x.shape[1:-1])
    xb = x.reshape(N_LIMBS, -1, n)
    B = xb.shape[1]
    tws = _twiddle_shards(k, inverse, mesh.devices)

    a = [r.reshape(N_LIMBS, B, d, m) for r in shard_batch(mesh, xb)]  # [j1 chunk q, l]
    a = all_to_all(a, 2, 2)  # shard q: [j1, l] at j2 = q*m + l
    out = []
    for s, tw in zip(a, tws):
        with on(s.device):
            s = ntt(s.transpose(2, 3), k1_bits, inverse).transpose(2, 3)  # j1 -> k1
            out.append(f.mont_mul(f.FR, s, tw[:, None]))
    a = all_to_all(out, 2, 2)  # shard k1: [p, l] at j2 = p*m + l
    rows = []
    for s in a:
        with on(s.device):
            rows.append(ntt(s.reshape(N_LIMBS, B, n2), k - k1_bits, inverse))  # j2 -> k2
    return gather(rows, mesh.devices[0], 2).reshape((N_LIMBS,) + batch + (d, n2))


def reorder_output(out: torch.Tensor) -> torch.Tensor:
    """(8, *batch, d, n2) four-step layout -> (8, *batch, n) natural order:
    X[k2*d + k1] from [k1, k2]."""
    d, n2 = out.shape[-2], out.shape[-1]
    return out.movedim(-2, -1).reshape(tuple(out.shape[:-2]) + (d * n2,))


def ntt_natural(mesh: Mesh, x: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """Distributed NTT in natural index order."""
    return reorder_output(ntt_distributed(mesh, x, k, inverse))
