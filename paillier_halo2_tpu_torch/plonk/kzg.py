"""KZG polynomial commitments over the monomial SRS.

Counterpart of `paillier_halo2_tpu/plonk/kzg.py:1`. Inside
`poly.ops.proving_mesh(mesh)`, a commitment whose width the mesh size d > 1
divides takes the sharded MSM (`mesh/msm.py`) before anything else, on the
CPU too, as `kzg.py:95-112` does. Otherwise the SRS tensors' device picks
the engine, as the JAX package's `_use_native_backend()` does
(`kzg.py:54-67, 116-117`):

- on the card, the port's MSM (`msm/pippenger.py`), whose route follows the
  device too: signed windows through K5 and K6;
- on the CPU, the native C++ Pippenger (`native/g1_msm_raw`), with the SRS
  encoded once per SRS object (`_native_srs_bytes`, `_commit_many_native`,
  `kzg.py:32-80`), a phase's polynomials on threads of their own. Without
  the native library a CPU commitment raises.

A commitment is a point, so the engine changes no proof byte.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..ec import bn254
from ..ec import host as ech
from ..ff import field as f
from ..mesh import msm as mesh_msm
from ..msm.pippenger import msm_packed_multi
from ..poly import ops
from .srs import SRS


def commit(srs: SRS, coeffs_mont: torch.Tensor) -> ech.Point:
    """Commit to a polynomial given in Montgomery coefficient form (8, m)."""
    return commit_many(srs, [coeffs_mont])[0]


def _srs_bases(srs: SRS, m: int):
    """Contiguous SRS base slices of width m, cached on the SRS object."""
    cache = srs.__dict__.setdefault("_bases", {})
    if m not in cache:
        cache[m] = (
            srs.g1_px[:, :m].contiguous(),
            srs.g1_py[:, :m].contiguous(),
            srs.g1_inf[:m].contiguous(),
        )
    return cache[m]


def _native_srs_bytes(srs: SRS) -> tuple[bytes, bytes]:
    """The SRS bases as the native engine reads them, cached on the SRS
    object: 64 bytes per point (little-endian affine x, y in standard form,
    zeros at infinity) and one infinity byte per point."""
    if "_native" not in srs.__dict__:
        xy = torch.cat([f.from_mont(bn254.SPEC, srs.g1_px), f.from_mont(bn254.SPEC, srs.g1_py)])
        inf = srs.g1_inf.cpu().numpy()
        rows = xy.cpu().numpy().view(np.uint32).T.copy()  # (n, 16): x limbs, then y limbs
        rows[inf] = 0
        srs.__dict__["_native"] = (rows.tobytes(), inf.astype(np.uint8).tobytes())
    return srs.__dict__["_native"]


def _commit_many_native(srs: SRS, coeffs_list, m: int) -> list[ech.Point]:
    """One native MSM per polynomial, on as many threads as torch's
    intra-op pool (`torch.set_num_threads`): the engine's MSM is
    single-threaded and re-entrant, and ctypes releases the interpreter
    lock for the call."""
    pts_b, infs_b = _native_srs_bytes(srs)
    pts_b, infs_b = pts_b[: 64 * m], infs_b[:m]
    scalars = [f.from_mont(f.FR, c).numpy().view(np.uint32).T.tobytes() for c in coeffs_list]
    native.lib()  # built once here, before any thread asks for it
    workers = min(len(scalars), torch.get_num_threads())
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda sc: native.g1_msm_raw(pts_b, infs_b, sc, m), scalars))


def commit_many(srs: SRS, coeffs_list) -> list[ech.Point]:
    """Commit a whole phase's polynomials in one batched MSM (equal widths)."""
    if not coeffs_list:
        return []
    m = coeffs_list[0].shape[1]
    assert all(c.shape[1] == m for c in coeffs_list), "pad polys to equal width"
    assert m <= srs.n
    mesh = ops.active_mesh()
    sharded = mesh is not None and mesh.size > 1 and m % mesh.size == 0
    if srs.device.type == "cpu" and not sharded:
        return _commit_many_native(srs, coeffs_list, m)
    stacked = f.from_mont(f.FR, torch.stack(coeffs_list, dim=1))  # (8, P, m)
    scalars = stacked.permute(1, 0, 2).contiguous()  # (P, 8, m)
    px, py, pinf = _srs_bases(srs, m)
    if sharded:
        return mesh_msm.msm_sharded_multi(mesh, px, py, pinf, scalars)
    return msm_packed_multi(px, py, pinf, scalars)
