"""ctypes binding of the port's native planner (``native/planner.cc``).

Counterpart: ``regent_fft_tpu/native/planner.py``.  The library is a host
one, built with ``$CXX`` (default ``g++``) at first use into
``build/regent_fft_tpu_torch/libplanner-<platform>-<hash>.so``, the hash
covering the source and the flags, as ``ops/_build.py`` builds the CUDA
kernels; nothing builds at import.  Where no compiler is found or the
build fails, :func:`load` returns None and every entry returns None (the
callers in ``ops/factor.py``, ``utils/measure.py`` and ``Plan.cost`` fall
back as the JAX package's do).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Tuple

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "planner.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
_build_err: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libplanner-{sys.platform}-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    """Compile into a per-process name, then move it into place (workers
    that build at once each land a whole file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd}: {e}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{cmd}: {r.stderr[-2000:]}"
    os.replace(tmp, so)
    return None


def load() -> Optional[ctypes.CDLL]:
    """The bound library, building it first if its hash is new; None when
    it cannot be built.  Counterpart: ``native/planner.py:53``."""
    global _lib, _build_err
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_err is not None:
            return None
        so = library_path()
        if not so.exists():
            _build_err = _build(so)
            if _build_err is not None:
                from ..utils.plog import logger
                logger.info("native planner build failed, using the Python "
                            "fallback: %s", _build_err)
                return None
        lib = ctypes.CDLL(str(so))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.rftp_factorize.restype = ctypes.c_int
        lib.rftp_factorize.argtypes = [ctypes.c_uint64, ctypes.c_uint32,
                                       u32p, ctypes.c_int]
        lib.rftp_best_schedule.restype = ctypes.c_int
        lib.rftp_best_schedule.argtypes = lib.rftp_factorize.argtypes
        lib.rftp_next_fast_len.restype = ctypes.c_uint64
        lib.rftp_next_fast_len.argtypes = [ctypes.c_uint64]
        lib.rftp_stage_flops.restype = ctypes.c_double
        lib.rftp_stage_flops.argtypes = [ctypes.c_uint64, u32p, ctypes.c_int]
        lib.rftp_set_cost_params.restype = None
        lib.rftp_set_cost_params.argtypes = [ctypes.c_double] * 5
        lib.rftp_schedule_cost.restype = ctypes.c_double
        lib.rftp_schedule_cost.argtypes = [ctypes.c_uint64, ctypes.c_uint32]
        lib.rftp_version.restype = ctypes.c_int
        lib.rftp_version.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _schedule_call(fn_name: str, n: int, max_radix: int):
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint32 * 64)()
    cnt = getattr(lib, fn_name)(n, max_radix, buf, 64)
    return tuple(buf[i] for i in range(cnt)) if cnt else None


def factorize(n: int, max_radix: int = 128) -> Optional[Tuple[int, ...]]:
    """Greedy largest-first radices (``ops/factor.factorize``'s answer).
    Counterpart: ``native/planner.py:95``."""
    return _schedule_call("rftp_factorize", n, max_radix)


def best_schedule(n: int, max_radix: int = 128) -> Optional[Tuple[int, ...]]:
    """The cost model's schedule (direct, best two-factor split, else the
    cheapest flattened factorization), None if n is not smooth.
    Counterpart: ``native/planner.py:106``."""
    return _schedule_call("rftp_best_schedule", n, max_radix)


def next_fast_len(n: int) -> Optional[int]:
    """Smallest 5-smooth size >= n.  Counterpart: ``native/planner.py:117``."""
    lib = load()
    return None if lib is None else int(lib.rftp_next_fast_len(n))


def stage_flops(n: int, factors) -> Optional[float]:
    """Real flops of a schedule: 8 n r a stage, 6 n a twiddle between
    stages (``ops/factor.stage_flops``)."""
    lib = load()
    if lib is None:
        return None
    arr = (ctypes.c_uint32 * len(factors))(*factors)
    return float(lib.rftp_stage_flops(n, arr, len(factors)))


def set_cost_params(mxu_edge=128.0, mxu_rate=1.0, vpu_rate=0.05,
                    stage_overhead=64.0, bw_unit=100.0) -> bool:
    """Set the cost model's parameters (the defaults are the reference's;
    ``utils/calibrate.install_calibration`` sets measured ones).
    ``bw_unit`` is a byte of device-memory traffic in matmul-flop time
    units.  Counterpart: ``native/planner.py:124``."""
    lib = load()
    if lib is None:
        return False
    lib.rftp_set_cost_params(mxu_edge, mxu_rate, vpu_rate, stage_overhead,
                             bw_unit)
    return True


def schedule_cost(n: int, max_radix: int = 128) -> Optional[float]:
    """Modeled cost of the best schedule per batch row (None where n is
    not smooth).  Counterpart: ``native/planner.py:139``."""
    lib = load()
    if lib is None:
        return None
    c = lib.rftp_schedule_cost(n, max_radix)
    return None if c < 0 else float(c)


def version() -> Optional[int]:
    lib = load()
    return None if lib is None else int(lib.rftp_version())
