"""Build the CUDA kernels at first use and bind them with ctypes.

Counterpart: the build shim of ``regent_fft_tpu/native/planner.py``.  Each
``regent_fft_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) and the objects are linked into
``build/regent_fft_tpu_torch/libstockham_<hash>.so`` beside the package
(the hash covers the sources, the headers and the flags, so an edit
rebuilds), then loaded with ``ctypes``.  Nothing here runs at import: hosts without
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

from ..utils import trace as _trace

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "regent_fft_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the csrc/*.cu entry points (all return cudaError_t).
_SIGNATURES = {
    "fft_last": [_P, _P, _P, _P, _L, _I, _I, _F, _P, _I, _IP, _P],
    "fft_cols": [_P, _P, _P, _P, _L, _I, _I, _I, _F, _P, _I, _IP, _P],
    "fft_fused2": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _F,
                   _P, _I, _IP, _P, _I, _IP, _P],
    "fft_fused2_clusters": [_I, _I, _I, _I, _I],
    "fft_last_residency": [_I, _I, _IP],
    "fft_last_real_residency": [_I, _I, _IP],
    "fft_cols_residency": [_I, _I, _IP],
    "fft_cols_fs_residency": [_I, _I, _I, _IP],
    "fft_gap": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F,
                _P, _I, _IP, _P, _I, _IP, _P],
    "fft_last_r2c": [_P, _P, _P, _L, _I, _I, _F, _P, _I, _IP, _P],
    "ifft_last_c2r": [_P, _P, _P, _L, _I, _I, _F, _P, _I, _IP, _P],
    "fft_cols_tw": [_P, _P, _P, _P, _L, _I, _I, _I, _P, _I, _IP, _P],
    "a0fs_a": [_P, _P, _P, _P, _L, _I, _I, _L, _I, _P, _I, _IP, _P],
    "a0fs_b": [_P, _P, _P, _P, _L, _I, _I, _L, _I, _F, _P, _I, _IP, _P],
    "fft_axis_ring": [_P, _P, _P, _P, _L, _I, _I, _I, _F, _P, _I, _IP, _P],
    "fft_axes2_ring": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _F,
                       _P, _I, _IP, _P, _I, _IP, _P],
    "fft_axes2_ring_clusters": [_I, _I, _I, _I],
    "fft_axis_ring_residency": [_I, _I, _IP],
    "fft_axis0": [_P, _P, _P, _P, _I, _L, _I, _F, _P, _I, _IP, _P],
    "fft_mm1": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P],
    "fft_mm2": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P],
}
# the bf16-plane (complex32) instances take the f32 entries' arguments
_SIGNATURES.update({k + "_bf16": _SIGNATURES[k]
                    for k in ("fft_last", "fft_cols", "fft_fused2", "fft_gap",
                              "a0fs_a", "a0fs_b", "fft_axis_ring",
                              "fft_axes2_ring")})

_LIB = None
build_seconds = None   # wall time of this process's nvcc runs, if it ran them
build_log = ""         # nvcc/ptxas output of those runs


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


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                               f"{' '.join(c)}\n{err}")
    return "".join(out + err for out, err in outs)


def _compile(so: Path):
    """One nvcc per source, all at once, then one link into ``so``."""
    global build_seconds, build_log
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(srcs, objs)])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    os.replace(tmp, so)


def load():
    """The bound kernel library, building it first if its hash is new.

    Raises RuntimeError, with the compiler's stderr, when nvcc is missing
    or the compile fails.
    """
    global _LIB
    if _LIB is not None:
        return _LIB
    with _trace.span("rft.build"):
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _LIB = lib
    return lib
