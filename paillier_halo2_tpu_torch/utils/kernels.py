"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The kernels have a plain C interface and are compiled with nvcc for Hopper
(`sm_90a`) into one shared library under the gitignored `build/kernels/`
directory at the repository root, keyed by a hash of the sources, on first
use: one nvcc per source, all started together, then one link. `ctypes`
loads it. Every pointer and the stream cross as `c_void_p`.
Each C entry point returns `cudaGetLastError()` after its launch, and
`check()` raises if that is not 0.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("mont_mul.cu", "g1_add.cu", "mont_mul_lazy.cu", "g1_add_lazy.cu", "field_addsub.cu")
HEADERS = ("field.cuh",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lib = None
BUILD_SECONDS: float | None = None  # wall time of the nvcc run, if this process built


CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default install


def _nvcc() -> str:
    path = shutil.which("nvcc") or (CUDA_NVCC if os.path.exists(CUDA_NVCC) else None)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_tag() -> str:
    h = hashlib.blake2b(digest_size=8)
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands at once; wait for all of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    for c, p in zip(cmds, procs):
        stdout, stderr = p.communicate()
        out.append(subprocess.CompletedProcess(c, p.returncode, stdout, stderr))
    return out


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path."""
    global BUILD_SECONDS
    so = os.path.join(BUILD_DIR, f"libpht_kernels_{_source_tag()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    compiles = [
        [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-c", "-o", o, os.path.join(CSRC, s)]
        for s, o in zip(SOURCES, objs)
    ]
    t0 = time.monotonic()
    try:
        results = _run_all(compiles)
        for r in results:
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-8000:]}")
        tmp = f"{so}.{tag}"
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-8000:]}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    BUILD_SECONDS = time.monotonic() - t0
    with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as fh:
        fh.write("".join(r.stderr for r in results))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        L.pht_mont_mul.argtypes = [vp, vp, vp, ll, ci, vp]
        L.pht_g1_jadd.argtypes = [vp] * 9 + [ll, ci, vp]
        L.pht_g1_madd.argtypes = [vp] * 9 + [ll, ci, ci, vp]
        L.pht_mont_mul_lazy.argtypes = [vp, vp, vp, ll, ci, vp]
        L.pht_g1_madd_lazy.argtypes = [vp] * 9 + [ll, vp]
        L.pht_g1_jadd_lazy.argtypes = [vp] * 9 + [ll, vp]
        L.pht_g1_window_sums.argtypes = [vp] * 6 + [ll, ll, vp]
        L.pht_g1_bucket_lazy.argtypes = [vp] * 12 + [ll, ll, vp]
        L.pht_g1_bucket.argtypes = [vp] * 11 + [ll, ll, vp]
        L.pht_g1_fixed_base_comb.argtypes = [vp] * 6 + [ll, vp]
        L.pht_g1_merge_lazy.argtypes = [vp] * 4 + [ll] + [vp] * 7 + [ll] * 6 + [vp]
        L.pht_field_addsub.argtypes = [vp] * 4 + [ci, ll, ci, ci, vp]
        fns = (L.pht_mont_mul, L.pht_g1_jadd, L.pht_g1_madd, L.pht_mont_mul_lazy,
               L.pht_g1_madd_lazy, L.pht_g1_jadd_lazy, L.pht_g1_window_sums,
               L.pht_g1_bucket_lazy, L.pht_g1_bucket, L.pht_g1_fixed_base_comb,
               L.pht_g1_merge_lazy, L.pht_field_addsub)
        for fn in fns:
            fn.restype = ci
        _lib = L
    return _lib


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
