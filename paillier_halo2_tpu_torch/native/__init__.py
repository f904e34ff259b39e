"""ctypes bindings for the native BN254 host engine.

Counterpart of `paillier_halo2_tpu/native/__init__.py:1`. The C++ source is
the port's own copy, `native/bn254.cpp` beside this file (the JAX package's
engine, unchanged), compiled with g++ into the gitignored `build/native/`
directory at the repository root, keyed by a hash of the source. The port uses
the engine for host work: `ec/host` scalar multiplications and additions, the
verifier's pairing check, and the KZG commitments and NTTs of a CPU proof
(`g1_msm_raw`, from `plonk/kzg.py`; `fr_ntt`, from `poly/ops.py`). Import
never fails: without a compiler `lib()` returns None; the host point
operations then take the pure-Python path, a CPU transform the plain torch
NTT, and a CPU commitment raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bn254.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")

_lib = None
_tried = False


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.blake2b(f.read(), digest_size=8).hexdigest()
    so = os.path.join(_BUILD_DIR, f"_bn254_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)
    return so


def lib():
    """Initialized ctypes library handle, or None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        L = ctypes.CDLL(so)
    except OSError:
        return None

    from ..ff.host import FQ_MOD as Q
    from ..ff.host import FR_MOD as R

    L.fp_ctx_init.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
    ]
    pt_args = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
    ]
    L.g1_add_c.argtypes = pt_args
    L.g1_mul_c.argtypes = pt_args
    L.g1_msm_c.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
    ]
    L.pairing_check_c.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    L.pairing_check_c.restype = ctypes.c_int
    L.fr_ctx_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    L.fr_ntt_c.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int,
    ]

    L.fr_ctx_init(
        R.to_bytes(32, "little"),
        ((1 << 512) % R).to_bytes(32, "little"),
        (-pow(R, -1, 1 << 64)) % (1 << 64),
    )
    ate_loop = 6 * 4965661367192848881 + 2
    L.fp_ctx_init(
        Q.to_bytes(32, "little"),
        ((1 << 512) % Q).to_bytes(32, "little"),
        (-pow(Q, -1, 1 << 64)) % (1 << 64),
        ate_loop & ((1 << 64) - 1),
        ate_loop >> 64,
    )
    _lib = L
    return _lib


def _enc_g1(p) -> tuple[bytes, int]:
    if p is None:
        return b"\x00" * 64, 1
    return p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little"), 0


def _dec_g1(buf, inf):
    if inf.value:
        return None
    b = bytes(buf)
    return (int.from_bytes(b[:32], "little"), int.from_bytes(b[32:], "little"))


def g1_add(p, q):
    pb, pi = _enc_g1(p)
    qb, qi = _enc_g1(q)
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.c_int()
    lib().g1_add_c(pb, pi, qb, qi, out, ctypes.byref(oinf))
    return _dec_g1(out.raw, oinf)


def g1_mul(p, k: int):
    pb, pi = _enc_g1(p)
    if k == 0 or pi:
        return None
    kb = int(k).to_bytes((k.bit_length() + 7) // 8, "little")
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.c_int()
    lib().g1_mul_c(pb, pi, kb, len(kb), out, ctypes.byref(oinf))
    return _dec_g1(out.raw, oinf)


def fr_ntt(data, k: int, inverse: bool) -> None:
    """In-place radix-2 NTT over Fr on a C-contiguous (batch, n, 32) uint8
    numpy array of little-endian Montgomery-form elements (n = 2^k), as
    `poly/ntt.py` `ntt` computes it (in-order DIT; the inverse includes the
    1/n scale). Rows run on the engine's threads. Raises ValueError on
    another dtype, layout or shape, RuntimeError without the library."""
    import numpy as np

    from ..ff.host import FR_MOD, root_of_unity

    n = 1 << k
    if data.dtype != np.uint8 or not data.flags["C_CONTIGUOUS"]:
        raise ValueError(f"fr_ntt takes a C-contiguous uint8 array, not {data.dtype} "
                         f"(C-contiguous: {data.flags['C_CONTIGUOUS']})")
    if data.ndim < 2 or data.shape[-2:] != (n, 32):
        raise ValueError(f"fr_ntt at k={k} takes (batch, {n}, 32) rows, not {data.shape}")
    L = lib()
    if L is None:
        raise RuntimeError("native BN254 engine unavailable (no g++?): no native NTT")
    w = root_of_unity(k)
    scale = b"\x00" * 32
    if inverse:
        w = pow(w, FR_MOD - 2, FR_MOD)
        scale = pow(n, FR_MOD - 2, FR_MOD).to_bytes(32, "little")
    L.fr_ntt_c(data.ctypes.data_as(ctypes.c_void_p), n, data.size // (n * 32),
               w.to_bytes(32, "little"), scale, 1 if inverse else 0)


def g1_msm_raw(pts: bytes, infs: bytes, scalars: bytes, n: int):
    """MSM over pre-encoded buffers: pts = n*64 bytes of little-endian affine
    (x, y), infs = n bytes, scalars = n*32 bytes little-endian (as the JAX
    package's `g1_msm_raw`, native/__init__.py:195). Raises without the
    library."""
    L = lib()
    if L is None:
        raise RuntimeError("native BN254 engine unavailable (no g++?): cannot commit on the CPU")
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.c_int()
    L.g1_msm_c(pts, infs, scalars, n, out, ctypes.byref(oinf))
    return _dec_g1(out.raw, oinf)


def g1_msm(points, scalars):
    n = len(points)
    pts = bytearray(64 * n)
    infs = bytearray(n)
    sc = bytearray(32 * n)
    for i, (p, s) in enumerate(zip(points, scalars)):
        b, inf = _enc_g1(p)
        pts[64 * i : 64 * (i + 1)] = b
        infs[i] = inf
        sc[32 * i : 32 * (i + 1)] = (int(s) % (1 << 256)).to_bytes(32, "little")
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.c_int()
    lib().g1_msm_c(bytes(pts), bytes(infs), bytes(sc), n, out, ctypes.byref(oinf))
    return _dec_g1(out.raw, oinf)


def pairing_check(pairs) -> bool:
    from ..ff.host import FQ_MOD as Q
    from ..ff.host import FR_MOD as R

    n = len(pairs)
    g1s = bytearray(64 * n)
    g1infs = bytearray(n)
    g2s = bytearray(128 * n)
    g2infs = bytearray(n)
    for i, (p, q) in enumerate(pairs):
        b, inf = _enc_g1(p)
        g1s[64 * i : 64 * (i + 1)] = b
        g1infs[i] = inf
        if q is None:
            g2infs[i] = 1
        else:
            (xc0, xc1), (yc0, yc1) = q
            g2s[128 * i : 128 * i + 128] = (
                xc0.to_bytes(32, "little")
                + xc1.to_bytes(32, "little")
                + yc0.to_bytes(32, "little")
                + yc1.to_bytes(32, "little")
            )
    fe = (Q**12 - 1) // R
    feb = fe.to_bytes((fe.bit_length() + 7) // 8, "little")
    ok = lib().pairing_check_c(
        bytes(g1s), bytes(g1infs), bytes(g2s), bytes(g2infs), n, feb, len(feb)
    )
    return bool(ok)
