"""Device polynomial utilities for the prover: host<->device packing,
coefficient/evaluation conversions, coset extension, evaluation, prefix
products, batch inversion, synthetic division.

Counterpart of `paillier_halo2_tpu/poly/ops.py:1`. All polynomials are
(8, ..., n) int32 Montgomery limb tensors, limb-first. Every function that
creates a tensor takes the device explicitly.

Transforms take one of three routes (`_ntt_any`, counted in `NTT_ROUTES`):
the four-step NTT over an active mesh (below); else, on a CPU tensor, the
native engine's C++ NTT (`native.fr_ntt`, `paillier_halo2_tpu/poly/ops.py:137-177`)
where the library builds; else the port's own NTT (`poly/ntt.py`, K1's
butterflies on the card). A CUDA tensor never goes to the host.
`ntt_backend("torch" | "native")` forces a route for tests, in place of
the JAX package's `PAILLIER_TPU_NTT_BACKEND`.

Inside `proving_mesh(mesh)` (the distributed prover, `plonk/distributed.py`)
every transform of size n with d > 1 and d^2 | n runs as the four-step NTT
over the mesh (`mesh/ntt.py`), and every commitment whose width d divides
takes the sharded MSM (`plonk/kzg.py`); the prover's own tensors stay on
`mesh.devices[0]`, as in `paillier_halo2_tpu/poly/ops.py:27-59`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native
from ..ff import field as f
from ..ff import host
from ..mesh.ntt import ntt_natural
from .ntt import ntt

SPEC = f.FR
P = host.FR_MOD
N_LIMBS = 8

# host<->device transfer counters (bench.py reports them per proof)
TRANSFER_COUNTS = {"h2d": 0, "d2h": 0}


def reset_transfer_counts() -> dict:
    prev = dict(TRANSFER_COUNTS)
    TRANSFER_COUNTS["h2d"] = TRANSFER_COUNTS["d2h"] = 0
    return prev


# -- distributed execution -------------------------------------------------------

_ACTIVE_MESH = None


class proving_mesh:
    """Context manager that routes the prover's NTTs and commitments over a
    mesh: `with ops.proving_mesh(mesh): ...`."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def active_mesh():
    """The mesh of the innermost `proving_mesh`, or None."""
    return _ACTIVE_MESH


def _mesh_for(n: int):
    """The active mesh, if a transform of size n can ride the four-step NTT."""
    m = _ACTIVE_MESH
    if m is None:
        return None
    d = m.size
    return m if d > 1 and n % (d * d) == 0 else None


# -- transform routes --------------------------------------------------------------

NTT_BACKENDS = ("auto", "torch", "native")
NTT_ROUTES = {"mesh": 0, "native": 0, "torch": 0}  # transforms taken by each route
_NTT_BACKEND = "auto"


class ntt_backend:
    """Context manager that picks the route of the transforms outside a
    mesh: `"auto"` (the default: native on a CPU tensor where the library
    builds, else torch), `"torch"` (the port's NTT, the card's arithmetic,
    on every device) or `"native"` (the C++ NTT; a CUDA tensor or a missing
    library then raises ValueError)."""

    def __init__(self, backend: str):
        if backend not in NTT_BACKENDS:
            raise ValueError(f"unknown NTT backend {backend!r}; one of {NTT_BACKENDS}")
        self.backend = backend

    def __enter__(self):
        global _NTT_BACKEND
        self._prev = _NTT_BACKEND
        _NTT_BACKEND = self.backend
        return self.backend

    def __exit__(self, *exc):
        global _NTT_BACKEND
        _NTT_BACKEND = self._prev
        return False


def reset_ntt_routes() -> dict:
    prev = dict(NTT_ROUTES)
    for key in NTT_ROUTES:
        NTT_ROUTES[key] = 0
    return prev


def _use_native(x: torch.Tensor) -> bool:
    if _NTT_BACKEND == "torch":
        return False
    if _NTT_BACKEND == "native":
        if x.device.type != "cpu":
            raise ValueError(f"the native NTT runs on the host; refusing a {x.device} tensor")
        if native.lib() is None:
            raise ValueError("the native NTT was asked for, but the native library did not build")
        return True
    return x.device.type == "cpu" and native.lib() is not None


def _ntt_native(x: torch.Tensor, k: int, inverse: bool) -> torch.Tensor:
    """The C++ NTT on a CPU tensor: (8, *batch, n) int32 limbs viewed as the
    engine's (B, n, 32) little-endian bytes, transformed in place, and
    viewed back."""
    n = 1 << k
    batch = x.shape[1:-1]
    rows = x.reshape(N_LIMBS, -1, n).permute(1, 2, 0).contiguous()  # (B, n, 8)
    native.fr_ntt(rows.view(torch.uint8).numpy(), k, inverse)
    return rows.permute(2, 0, 1).reshape((N_LIMBS,) + tuple(batch) + (n,)).contiguous()


def _ntt_any(x: torch.Tensor, k: int, inverse: bool) -> torch.Tensor:
    mesh = _mesh_for(1 << k)
    if mesh is not None:
        NTT_ROUTES["mesh"] += 1
        return ntt_natural(mesh, x, k, inverse)
    if _use_native(x):
        NTT_ROUTES["native"] += 1
        return _ntt_native(x, k, inverse)
    NTT_ROUTES["torch"] += 1
    return ntt(x, k, inverse)


# -- packing -------------------------------------------------------------------


def pack_values(vals, device) -> torch.Tensor:
    """Object-int array/list of any shape S -> (8, *S) int32 standard-form
    limbs. Values below 2^63 take a vectorized int64 path."""
    arr = np.asarray(vals, dtype=object)
    flat = arr.reshape(-1)
    n = len(flat)
    try:
        small = flat.astype(np.int64)
    except (OverflowError, TypeError):
        small = None
    if small is not None and n and (small >= 0).all():
        u = small.astype(np.uint64)
        limbs = np.zeros((N_LIMBS, n), dtype=np.uint32)
        limbs[0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        limbs[1] = (u >> np.uint64(32)).astype(np.uint32)
    else:
        buf = b"".join(int(v).to_bytes(32, "little") for v in flat)
        limbs = np.frombuffer(buf, dtype=np.uint32).reshape(n, N_LIMBS).T
    out = np.ascontiguousarray(limbs).view(np.int32).reshape((N_LIMBS,) + arr.shape)
    return torch.from_numpy(out.copy()).to(device)


def unpack_values(t: torch.Tensor) -> list[int]:
    """(8, ...) limbs -> flat list of ints (row-major over the batch)."""
    return f.unpack_ints(t)


def to_device_mont(vals, device) -> torch.Tensor:
    TRANSFER_COUNTS["h2d"] += 1
    return f.to_mont(SPEC, pack_values(vals, device))


def from_device_mont(t: torch.Tensor) -> list[int]:
    TRANSFER_COUNTS["d2h"] += 1
    return unpack_values(f.from_mont(SPEC, t))


def fr_digits_mont(x: int, device) -> torch.Tensor:
    """(8,) Montgomery limbs of a host Fr value."""
    return f.pack_ints([x % P * SPEC.r_mod_p % P], device)[:, 0]


def _mont_consts(vals: list[int], device) -> torch.Tensor:
    """(8, len) Montgomery limbs of host values."""
    return f.pack_ints([v % P * SPEC.r_mod_p % P for v in vals], device)


# -- coefficient <-> evaluation ------------------------------------------------


def coeffs_of(values: torch.Tensor, k: int) -> torch.Tensor:
    """Evaluations over H (natural order) -> coefficients."""
    return _ntt_any(values, k, inverse=True)


def values_of(coeffs: torch.Tensor, k: int) -> torch.Tensor:
    return _ntt_any(coeffs, k, inverse=False)


@functools.lru_cache(maxsize=None)
def _coset_scale(k: int, device: str) -> torch.Tensor:
    """Montgomery g^i for i < 2^k (coset shift before the extended NTT)."""
    out, acc = [], 1
    for _ in range(1 << k):
        out.append(acc)
        acc = acc * host.FR_GENERATOR % P
    return _mont_consts(out, device)


@functools.lru_cache(maxsize=None)
def _coset_unscale(k_ext: int, device: str) -> torch.Tensor:
    g_inv = pow(host.FR_GENERATOR, P - 2, P)
    out, acc = [], 1
    for _ in range(1 << k_ext):
        out.append(acc)
        acc = acc * g_inv % P
    return _mont_consts(out, device)


def extended_coset_evals(coeffs: torch.Tensor, k: int, k_ext: int) -> torch.Tensor:
    """Evaluate degree-<2^k polynomials on the extended coset g*H_ext.
    Batched along any middle axes: (8, ..., 2^k) -> (8, ..., 2^k_ext)."""
    batch = tuple(coeffs.shape[1:-1])
    ones = (1,) * len(batch)
    scale = _coset_scale(k, str(coeffs.device)).reshape((N_LIMBS,) + ones + (1 << k,))
    padded = torch.zeros(
        (N_LIMBS,) + batch + (1 << k_ext,), dtype=torch.int32, device=coeffs.device
    )
    padded[..., : 1 << k] = f.mont_mul(SPEC, coeffs, scale)
    return _ntt_any(padded, k_ext, inverse=False)


def coeffs_from_extended(evals_ext: torch.Tensor, k: int, k_ext: int) -> torch.Tensor:
    """Inverse of extended_coset_evals: coset evals -> coefficients (2^k_ext)."""
    batch = tuple(evals_ext.shape[1:-1])
    ones = (1,) * len(batch)
    coeffs = _ntt_any(evals_ext, k_ext, inverse=True)
    scale = _coset_unscale(k_ext, str(evals_ext.device)).reshape(
        (N_LIMBS,) + ones + (1 << k_ext,)
    )
    return f.mont_mul(SPEC, coeffs, scale)


# -- sums and scans --------------------------------------------------------------


def _hillis(arr: torch.Tensor, op, reverse: bool) -> torch.Tensor:
    """Inclusive prefix (or suffix) scan of a field op along the LAST axis:
    log2(n) full-width rounds."""
    n = arr.shape[-1]
    j = torch.arange(n, device=arr.device)
    for i in range((n - 1).bit_length()):
        shift = 1 << i
        rolled = torch.roll(arr, -shift if reverse else shift, dims=-1)
        mask = (j < n - shift) if reverse else (j >= shift)
        arr = torch.where(mask, op(arr, rolled), arr)
    return arr


def _mul(a, b):
    return f.mont_mul(SPEC, a, b)


def _add(a, b):
    return f.add(SPEC, a, b)


def _suffix_sum(arr: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum (mod p) along the LAST axis."""
    return _hillis(arr, _add, reverse=True)


def prefix_product(arr: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the LAST axis (Montgomery form)."""
    return _hillis(arr, _mul, reverse=False)


def _sum_reduce(arr: torch.Tensor) -> torch.Tensor:
    """Tree-sum along the LAST axis (mod p): (8, ..., n) -> (8, ..., 1)."""
    return sum_axis(arr, arr.dim() - 1).unsqueeze(-1)


def sum_axis(arr: torch.Tensor, axis: int) -> torch.Tensor:
    """Tree-sum (mod p) along one axis, removing it."""
    n = arr.shape[axis]
    while n > 1:
        half = (n + 1) // 2
        if half * 2 > n:
            pad_shape = list(arr.shape)
            pad_shape[axis] = half * 2 - n
            arr = torch.cat([arr, arr.new_zeros(pad_shape)], dim=axis)
        arr = _add(arr.narrow(axis, 0, half), arr.narrow(axis, half, half))
        n = half
    return arr.squeeze(axis)


def powers_dev(xs: list[int], n: int, device) -> torch.Tensor:
    """(8, len(xs), n) Montgomery power tables: row j is [1, x_j, x_j^2, ...]."""
    m = len(xs)
    base = _mont_consts(xs, device)
    one = SPEC.limbs("one_mont", device)
    arr = torch.cat(
        [
            one[:, None, None].expand(N_LIMBS, m, 1),
            base[:, :, None].expand(N_LIMBS, m, n - 1),
        ],
        dim=2,
    )
    return prefix_product(arr)


def eval_at(coeffs: torch.Tensor, x: int) -> int:
    """f(x) for a host point x: device inner product with host powers of x."""
    n = coeffs.shape[1]
    powers, acc = [], 1
    for _ in range(n):
        powers.append(acc)
        acc = acc * x % P
    pw = to_device_mont(powers, coeffs.device)
    return from_device_mont(_sum_reduce(_mul(coeffs, pw)))[0]


def batch_inverse(arr: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of nonzero Montgomery values along the LAST axis
    by the product trick: inv(a_i) = pre_{i-1} * suf_{i+1} * T^-1 — two scans
    and one Fermat ladder per row."""
    n = arr.shape[-1]
    if n == 1:
        return f.mont_inv(SPEC, arr)
    pre = prefix_product(arr)
    suf = _hillis(arr, _mul, reverse=True)
    one_col = f._bcast(SPEC.limbs("one_mont", arr.device), arr.dim()).expand(
        arr.shape[:-1] + (1,)
    )
    total_inv = f.mont_inv(SPEC, pre[..., -1:].contiguous())
    pre_shift = torch.cat([one_col, pre[..., :-1]], dim=-1)
    suf_shift = torch.cat([suf[..., 1:], one_col], dim=-1)
    return _mul(_mul(pre_shift, suf_shift), total_inv)


def synthetic_divide(coeffs: torch.Tensor, z: int) -> torch.Tensor:
    """(f(X) - f(z)) / (X - z) in coefficient form; returns quotient coeffs
    (same length, top coefficient zero): q_i = z^-(i+1) * sum_{j>i} c_j z^j."""
    n = coeffs.shape[1]
    zeros = torch.zeros((N_LIMBS, 1), dtype=torch.int32, device=coeffs.device)
    if z % P == 0:
        return torch.cat([coeffs[:, 1:], zeros], dim=1)
    zinv = pow(z, P - 2, P)
    zpow, zinvpow = [], []
    acc, iacc = 1, zinv
    for _ in range(n):
        zpow.append(acc)
        zinvpow.append(iacc)
        acc = acc * z % P
        iacc = iacc * zinv % P
    d = _mul(coeffs, _mont_consts(zpow, coeffs.device))
    incl = _suffix_sum(d)
    s = torch.cat([incl[:, 1:], zeros], dim=1)
    return _mul(s, _mont_consts(zinvpow, coeffs.device))
