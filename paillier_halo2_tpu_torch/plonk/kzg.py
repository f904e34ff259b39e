"""KZG polynomial commitments over the monomial SRS (commit = MSM on the
device).

Counterpart of `paillier_halo2_tpu/plonk/kzg.py:1`, without the mesh and the
native-CPU routing: every commitment runs the port's own MSM
(`msm/pippenger.py`), on the SRS's device.
"""
from __future__ import annotations

import torch

from ..ec import host as ech
from ..ff import field as f
from ..msm.pippenger import msm_packed_multi
from .srs import SRS

DEFAULT_WINDOW_BITS = 8


def commit(srs: SRS, coeffs_mont: torch.Tensor, window_bits: int = DEFAULT_WINDOW_BITS) -> ech.Point:
    """Commit to a polynomial given in Montgomery coefficient form (8, m)."""
    return commit_many(srs, [coeffs_mont], window_bits)[0]


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


def commit_many(srs: SRS, coeffs_list, window_bits: int = DEFAULT_WINDOW_BITS) -> list[ech.Point]:
    """Commit a whole phase's polynomials in one batched MSM (equal widths)."""
    if not coeffs_list:
        return []
    m = coeffs_list[0].shape[1]
    assert all(c.shape[1] == m for c in coeffs_list), "pad polys to equal width"
    assert m <= srs.n
    stacked = f.from_mont(f.FR, torch.stack(coeffs_list, dim=1))  # (8, P, m)
    scalars = stacked.permute(1, 0, 2).contiguous()  # (P, 8, m)
    px, py, pinf = _srs_bases(srs, m)
    return msm_packed_multi(px, py, pinf, scalars, window_bits=window_bits)
