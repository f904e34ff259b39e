"""Proving-key serialization: save a key once, load it instead of running
keygen again.

Counterpart of `paillier_halo2_tpu/plonk/serialize.py:1`, in the same
format, so a key written by either package loads in the other: one `.npz`
(no pickle) holding a JSON `meta` entry, the verifying key's points as
`(m, 3, 32)` uint32 rows (x digits, y digits, an infinity flag), every
coefficient column as `(32, n)` uint32 8-bit digits in Montgomery form
(R = 2^256, as on the device), and the object-int arrays as `(32, *shape)`
digits in standard form. The port's `(8, *batch)` int32 limbs cross to and
from those digits through `ff.field.to_ref_digits` / `from_ref_digits`.

Deliberate differences from the JAX package:
- `table_fingerprint` hashes the multi-open scheme and each array's name and
  shape, under the prefix `v2`; the JAX package's `v1` fingerprint does
  neither, so two tables whose arrays differ only in where one ends and the
  next begins share it. A key saved with a `v1` fingerprint therefore never
  matches an `expect_table_fp` of the port, and the caller falls back to
  keygen; without `expect_table_fp` it loads.
- an SRS smaller than the key's raises ValueError (an `assert` there).
- the key does not keep the permutation's identity and sigma values; they
  are rebuilt from the layout when the key is saved, and not read on load.
"""
from __future__ import annotations

import hashlib
import json
import zipfile

import numpy as np
import torch

from ..ff import field as f
from ..poly import ops
from .keygen import ProvingKey, VerifyingKey, check_multiopen, permutation_powers
from .layout import CircuitLayout
from .params import ConfigParams
from .srs import SRS

P = ops.P
FINGERPRINT_VERSION = "v2"


def _digits(vals) -> np.ndarray:
    """Object ints of any shape S -> (32, *S) uint32 8-bit digits."""
    return f.to_ref_digits(ops.pack_values(vals, "cpu"))


def _ints(d: np.ndarray) -> np.ndarray:
    """(32, *S) digits -> object-int array of shape S."""
    return np.array(f.unpack_ints(f.from_ref_digits(d, "cpu")), dtype=object).reshape(d.shape[1:])


def table_fingerprint(table, k: int, lookup_bits: int, multiopen: str = "shplonk") -> str:
    """Structural fingerprint of (circuit, k, lookup_bits, multi-open scheme)
    for validating a cached key: gate, copy, constant, lookup and public
    positions and the constant values, each array under its name and shape;
    not the witness values, which change per statement without changing the
    key. Bump FINGERPRINT_VERSION on any layout-semantics change."""
    check_multiopen(multiopen)
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{FINGERPRINT_VERSION}|{k}|{lookup_bits}|{multiopen}|{table.n_rows}|".encode())
    for name in ("gates", "copy_a", "copy_b", "const_idx", "lookups", "publics"):
        arr = np.ascontiguousarray(getattr(table, name), dtype=np.int64)
        h.update(f"{name}{arr.shape}|".encode())
        h.update(arr.tobytes())
    const = _digits(table.const_val)
    h.update(f"const_val{const.shape}|".encode())
    h.update(const.tobytes())
    return h.hexdigest()


def _points_pack(points) -> np.ndarray:
    """Affine points ((x, y) ints, or None for infinity) -> (m, 3, 32) uint32."""
    if not points:
        return np.zeros((0, 3, 32), dtype=np.uint32)
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    inf = np.array([p is None for p in points], dtype=np.uint32)
    return np.stack([_digits(xs).T, _digits(ys).T, np.repeat(inf[:, None], 32, axis=1)], axis=1)


def _points_unpack(arr: np.ndarray) -> list:
    xs, ys = _ints(arr[:, 0].T), _ints(arr[:, 1].T)
    return [None if int(row[2, 0]) else (int(x), int(y)) for row, x, y in zip(arr, xs, ys)]


def _cols_digits(cols: list[torch.Tensor]) -> np.ndarray:
    """(8, n) limb columns -> (m, 32, n) digits."""
    return np.moveaxis(f.to_ref_digits(torch.stack(cols, dim=1)), 1, 0)


def _cols_limbs(d: np.ndarray, device) -> list[torch.Tensor]:
    """(m, 32, n) digits -> m (8, n) limb columns on `device`."""
    stack = f.from_ref_digits(np.moveaxis(d, 0, 1), device)
    return [stack[:, i].contiguous() for i in range(stack.shape[1])]


def _savez_deflated(path: str, **arrays) -> None:
    """`np.savez_compressed`'s layout, one deflated `.npy` entry per array,
    at deflate level 1 in place of zlib's default 6: the digit arrays (three
    bytes in four are zero) compress to the same size in about a seventh of
    the time."""
    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asanyarray(arr), allow_pickle=False)


def save_proving_key(pk: ProvingKey, path: str, table_fp: str | None = None) -> None:
    """Write `pk` to `path` (`.npz` is appended to a name without it). The
    key's tensors are read from the device it lives on, the SRS's."""
    vk, layout = pk.vk, pk.layout
    meta = {
        "table_fp": table_fp,
        "k": vk.k,
        "lookup_bits": vk.lookup_bits,
        "num_advice": vk.num_advice,
        "num_lookup_advice": vk.num_lookup_advice,
        "n_perm_cols": vk.n_perm_cols,
        "perm_chunks": vk.perm_chunks,
        "usable": vk.usable,
        "multiopen": vk.multiopen,
        "num_instance": vk.num_instance,
        "layout_n": layout.n,
        "n_virtual": layout.n_virtual,
        "config": vars(layout.config),
        "srs_k": pk.srs.k,
    }
    delta, omega = permutation_powers(vk.k, vk.n_perm_cols)
    _savez_deflated(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        q_commits=_points_pack(vk.q_commits),
        fixed_commits=_points_pack([vk.fixed_const_commit, vk.table_commit]),
        sigma_commits=_points_pack(vk.sigma_commits),
        q_coeffs=_cols_digits(pk.q_coeffs),
        fixed_const_coeffs=f.to_ref_digits(pk.fixed_const_coeffs),
        table_coeffs=f.to_ref_digits(pk.table_coeffs),
        sigma_coeffs=_cols_digits(pk.sigma_coeffs),
        active_coeffs=f.to_ref_digits(pk.active_coeffs),
        l0_coeffs=f.to_ref_digits(pk.l0_coeffs),
        lu_coeffs=f.to_ref_digits(pk.lu_coeffs),
        id_values=_digits(delta[:, None] * omega[None, :] % P),
        sigma_values=_digits(delta[layout.sigma_col] * omega[layout.sigma_row] % P),
        table_values=_digits(pk.table_values),
        fixed_const_values=_digits(pk.fixed_const_values),
        layout_col_of=layout.col_of,
        layout_row_of=layout.row_of,
        layout_q=layout.q,
        layout_fixed_const=_digits(layout.fixed_const),
        layout_sigma_col=layout.sigma_col,
        layout_sigma_row=layout.sigma_row,
        layout_lookup_src=layout.lookup_src,
        layout_publics=layout.publics,
    )


def load_proving_key(path: str, srs: SRS, expect_table_fp: str | None = None,
                     device="cuda") -> ProvingKey:
    """Load a key written by either package onto `device`, which must be
    the SRS's. With `expect_table_fp` the stored fingerprint must equal it
    (a key saved without one never does); else ValueError, so the caller
    runs keygen instead of proving with a stale layout. A key whose meta
    names no scheme was written before SHPLONK existed and loads as GWC."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the key; pass device='cpu' to load it on the CPU")
    if device.type != srs.device.type:
        raise ValueError(f"the SRS lies on {srs.device}, the key was asked for on {device}")
    with np.load(path, allow_pickle=False) as npz:
        # the permutation's id and sigma values are the JAX package's; the
        # port's key does not keep them
        z = {name: npz[name] for name in npz.files if name not in ("id_values", "sigma_values")}
    meta = json.loads(bytes(z["meta"]).decode())
    if srs.k < meta["srs_k"]:
        raise ValueError(f"SRS k={srs.k} is smaller than the key's k={meta['srs_k']}")
    if expect_table_fp is not None and meta.get("table_fp") != expect_table_fp:
        raise ValueError(
            f"proving-key cache {path} fingerprint mismatch: "
            f"stored={meta.get('table_fp')} expected={expect_table_fp}"
        )
    multiopen = meta.get("multiopen", "gwc")
    check_multiopen(multiopen)
    fixed2 = _points_unpack(z["fixed_commits"])
    vk = VerifyingKey(
        k=meta["k"],
        lookup_bits=meta["lookup_bits"],
        num_advice=meta["num_advice"],
        num_lookup_advice=meta["num_lookup_advice"],
        n_perm_cols=meta["n_perm_cols"],
        perm_chunks=[list(c) for c in meta["perm_chunks"]],
        usable=meta["usable"],
        multiopen=multiopen,
        num_instance=meta.get("num_instance", 0),
        q_commits=_points_unpack(z["q_commits"]),
        fixed_const_commit=fixed2[0],
        table_commit=fixed2[1],
        sigma_commits=_points_unpack(z["sigma_commits"]),
    )
    layout = CircuitLayout(
        config=ConfigParams(**meta["config"]),
        n=meta["layout_n"],
        col_of=z["layout_col_of"],
        row_of=z["layout_row_of"],
        q=z["layout_q"],
        fixed_const=_ints(z["layout_fixed_const"]),
        sigma_col=z["layout_sigma_col"],
        sigma_row=z["layout_sigma_row"],
        lookup_src=z["layout_lookup_src"],
        n_virtual=meta["n_virtual"],
        publics=z["layout_publics"] if "layout_publics" in z else np.zeros(0, np.int64),
    )
    (fixed_const, table, active, l0, lu) = (
        f.from_ref_digits(z[name], device)
        for name in ("fixed_const_coeffs", "table_coeffs", "active_coeffs", "l0_coeffs",
                     "lu_coeffs")
    )
    return ProvingKey(
        vk=vk,
        layout=layout,
        srs=srs,
        q_coeffs=_cols_limbs(z["q_coeffs"], device),
        fixed_const_coeffs=fixed_const,
        table_coeffs=table,
        sigma_coeffs=_cols_limbs(z["sigma_coeffs"], device),
        active_coeffs=active,
        l0_coeffs=l0,
        lu_coeffs=lu,
        table_values=_ints(z["table_values"]),
        fixed_const_values=_ints(z["fixed_const_values"]),
    )
