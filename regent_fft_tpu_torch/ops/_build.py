"""Build the CUDA kernels at first use and bind them with ctypes.

Counterpart: the build shim of ``regent_fft_tpu/native/planner.py``.  The
sources in ``regent_fft_tpu_torch/csrc/`` are compiled by ``nvcc`` into
``build/regent_fft_tpu_torch/libstockham_<hash>.so`` beside the package
(the hash covers the sources and the flags, so an edit rebuilds), then
loaded with ``ctypes``.  Nothing here runs at import: hosts without
``nvcc`` import the package and use the plain versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "regent_fft_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of csrc/stockham.cu's entry points (all return cudaError_t).
_SIGNATURES = {
    "fft_last": [_P, _P, _P, _P, _L, _I, _I, _F, _P, _I, _IP, _P],
    "fft_cols": [_P, _P, _P, _P, _L, _I, _I, _I, _F, _P, _I, _IP, _P],
    "fft_fused2": [_P, _P, _P, _P, _L, _I, _I, _I, _F,
                   _P, _I, _IP, _P, _I, _IP, _P],
}

_LIB = None
build_seconds = None   # wall time of this process's nvcc run, if it ran one
build_log = ""         # nvcc/ptxas output of that run


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of regent_fft_tpu_torch build at "
        "first use on a machine with the CUDA toolkit (PATH or "
        "/usr/local/cuda/bin)")


def library_path() -> Path:
    srcs = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libstockham_{h.hexdigest()[:16]}.so"


def load():
    """The bound kernel library, building it first if its hash is new.

    Raises RuntimeError, with the compiler's stderr, when nvcc is missing
    or the compile fails.
    """
    global _LIB, build_seconds, build_log
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(SRC_DIR.glob("*.cu")))]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = r.stdout + r.stderr
        if r.returncode:
            raise RuntimeError(f"nvcc failed (exit {r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib
