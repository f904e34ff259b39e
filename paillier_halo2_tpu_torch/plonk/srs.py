"""KZG structured reference string — dev-mode powers of tau, generated on the
device.

Counterpart of `paillier_halo2_tpu/plonk/srs.py:1`: a deterministic dev-mode
tau is derived from a seed; the G1 powers [tau^i]G are computed as a batched
fixed-base comb — 8-bit windows into a host-precomputed 32 x 256 table, K3's
mixed add per window, all 32 windows in one kernel launch
(`ec/point_kernels.fixed_base_comb`) — then normalized to affine on the
device with a batched Fermat inversion. The cache keeps the JAX package's npz
format and name (`params/kzg_bn254_dev_{k}.npz`, digits-first uint32
arrays); the port converts the layout when it loads or saves.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..ec import bn254
from ..ec import host as ech
from ..ec import point_kernels as pk
from ..ff import field as f
from ..ff.host import FR_MOD

DEFAULT_PARAMS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "params"
)
N_WINDOWS = pk.COMB_WINDOWS


@dataclasses.dataclass
class SRS:
    k: int
    g1_px: torch.Tensor  # (8, n) affine X, Montgomery limbs
    g1_py: torch.Tensor
    g1_inf: torch.Tensor  # (n,) bool
    g2_gen: ech.PointG2
    g2_tau: ech.PointG2

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def device(self) -> torch.device:
        return self.g1_px.device

    def g1_points(self, count: int | None = None) -> list[ech.Point]:
        """Unpack the first `count` G1 powers to host affine points."""
        count = self.n if count is None else count
        xs = f.unpack_ints(f.from_mont(bn254.SPEC, self.g1_px[:, :count]))
        ys = f.unpack_ints(f.from_mont(bn254.SPEC, self.g1_py[:, :count]))
        inf = self.g1_inf[:count].cpu().tolist()
        return [None if i else (x, y) for x, y, i in zip(xs, ys, inf)]


def _dev_tau(seed: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(b"paillier-tpu-dev-srs" + seed).digest(), "little") % FR_MOD


def _comb_table():
    """Host precompute: table[w][d] = d * 2^(8w) * G (affine), w < 32."""
    tbl = []
    base = ech.G1
    for _ in range(N_WINDOWS):
        row = [None]
        acc = None
        for _ in range(255):
            acc = ech.g1_add(acc, base)
            row.append(acc)
        tbl.append(row)
        for _ in range(8):
            base = ech.g1_double(base)
    return tbl


def batched_fixed_base_mul(scalars: list[int], device) -> bn254.JPoint:
    """[s_i]G for many scalars at once: acc_i = sum_w table[w][digit_{w,i}]."""
    flat = [p for row in _comb_table() for p in row]
    px, py, pinf = bn254.pack_affine(flat, device)
    sd = f.pack_ints([s % FR_MOD for s in scalars], device)  # (8, N)
    return pk.fixed_base_comb(bn254.pack_points_dense(px, py), pinf, sd)


def generate_srs(k: int, seed: bytes = b"", device="cuda") -> SRS:
    """Dev-mode SRS: tau from seed, [tau^i]G1 for i < 2^k, [1]G2, [tau]G2."""
    tau = _dev_tau(seed)
    powers, acc = [], 1
    for _ in range(1 << k):
        powers.append(acc)
        acc = acc * tau % FR_MOD
    X, Y, Z = batched_fixed_base_mul(powers, device)
    spec = bn254.SPEC
    zinv = f.mont_inv(spec, Z)
    zinv2 = f.mont_mul(spec, zinv, zinv)
    ax = f.mont_mul(spec, X, zinv2)
    ay = f.mont_mul(spec, Y, f.mont_mul(spec, zinv2, zinv))
    inf = f.is_zero(Z)
    return SRS(k, ax, ay, inf, ech.G2, ech.g2_mul(ech.G2, tau))


def cache_path(k: int, params_dir: str | None = None) -> str:
    return os.path.join(params_dir or DEFAULT_PARAMS_DIR, f"kzg_bn254_dev_{k}.npz")


def read_or_create_srs(k: int, seed: bytes = b"", device="cuda", params_dir: str | None = None
                       ) -> SRS:
    """Disk-cached SRS (halo2-base's read_or_create_srs). The cache holds the
    seed-b"" SRS, as in the JAX package."""
    path = cache_path(k, params_dir)
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        g2 = [int(s) for s in z["g2"]]
        return SRS(
            int(z["k"]),
            f.from_ref_digits(z["g1_px"], device),
            f.from_ref_digits(z["g1_py"], device),
            torch.from_numpy(z["g1_inf"].astype(bool)).to(device),
            ((g2[0], g2[1]), (g2[2], g2[3])),
            ((g2[4], g2[5]), (g2[6], g2[7])),
        )
    srs = generate_srs(k, seed, device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    g2_strs = np.array([str(c) for pt in (srs.g2_gen, srs.g2_tau) for coord in pt for c in coord])
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(
        tmp, k=srs.k, g1_px=f.to_ref_digits(srs.g1_px), g1_py=f.to_ref_digits(srs.g1_py),
        g1_inf=srs.g1_inf.cpu().numpy(), g2=g2_strs,
    )
    os.replace(tmp, path)
    return srs
