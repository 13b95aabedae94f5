"""One timing method for every reporter of the port.

Counterpart: ``regent_fft_tpu/utils/timing.py``.  ``chip_smoke.py``,
``Plan.benchmark``, ``bench_cli`` and the planner races
(``utils/measure.py``) all time through :func:`time_ms`:

* one untimed call first (it builds the kernel library, uploads tables
  and warms the caching allocator);
* on a CUDA device, each timed call runs between two
  ``torch.cuda.Event``s after a write of a 256 MiB buffer, which evicts
  the H100's 50 MB L2, so every call finds its input in device memory as
  a caller's first call does; on the CPU, ``time.perf_counter`` around
  the call;
* the result is the median of the runs.

The JAX module chains iterations inside one dispatch and takes a paired
difference because its TPU sat behind a remote attach whose round trip
swamped a dispatch; a CUDA event pair measures one call on the device
directly.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Tuple

import torch

from . import trace as _trace

FLUSH_BYTES = 256 << 20


def _device(device) -> torch.device:
    return torch.device("cpu" if device is None else device)


def time_ms(fn: Callable, reps: int = 10, device=None) -> float:
    """Median milliseconds of ``reps`` calls of ``fn()`` on ``device``
    (None: the CPU), after one untimed call; on a CUDA device each timed
    call follows an L2 flush and is bracketed by CUDA events."""
    dev = _device(device)
    fn()
    out = []
    if dev.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(statistics.median(out))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    torch.cuda.synchronize(dev)
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize(dev)
        out.append(a.elapsed_time(b))
    return float(statistics.median(out))


def methodology(device) -> str:
    """The name of the method :func:`time_ms` uses on ``device``."""
    return "cuda-events" if _device(device).type == "cuda" else "host-clock"


def plan_inputs(plan, seed: int = 0):
    """Arguments of ``plan.core_fn``: seeded normal planes of the plan's
    compute dtype on its device (one real plane for R2C, the half
    spectrum's pair for C2R), from a ``torch.Generator``."""
    from ..dtypes import Kind
    from ..plan import _half_shape
    s = plan.spec
    g = torch.Generator(device=plan.device).manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=g, device=plan.device).to(
            plan.cdtype)
    if s.kind == Kind.R2C:
        return (randn(s.shape),)
    shape = s.shape if s.kind == Kind.C2C else _half_shape(s)
    return randn(shape), randn(shape)


def time_plan(plan, reps: int = 10, seed: int = 0) -> float:
    """Seconds per call of the plan's split-plane core (``Plan.core_fn``:
    planes in, planes out, on the plan's device), the median of ``reps``.
    Counterpart: ``regent_fft_tpu/utils/timing.py:208``."""
    args = plan_inputs(plan, seed)
    core = plan.core_fn
    return 1e-3 * time_ms(lambda: core(*args), reps, plan.device)


def time_plan_latency(plan, iters: int = 5, seed: int = 0) -> float:
    """Seconds of the fastest of ``iters`` calls ``plan(x)`` on a fresh
    numpy input each, host-to-device copy and the plan's split and combine
    included, until the device is done: the latency view, not comparable
    to :func:`time_plan`.  Counterpart: ``timing.py:214``."""
    import numpy as np
    from ..dtypes import Kind
    from ..plan import _half_shape
    rng = np.random.default_rng(seed)
    s = plan.spec

    def fresh():
        if s.kind == Kind.R2C:
            return rng.standard_normal(s.shape).astype(np.float32)
        shape = s.shape if s.kind == Kind.C2C else _half_shape(s)
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def sync():
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)
    plan(fresh())
    sync()
    best = float("inf")
    for _ in range(iters):
        x = fresh()
        t0 = time.perf_counter()
        plan(x)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def measured_copy_gbps(nbytes: int = 2 ** 30, reps: int = 10,
                       min_bytes: int = 2 ** 30, device="cuda") -> float:
    """Device-memory bandwidth (GB/s) of ``dst.copy_(src)`` on ``nbytes``
    (at least ``min_bytes``, 1 GiB: well past the L2), counting the read
    and the write.  Counterpart: ``timing.py:247`` (a STREAM-scale
    chain there)."""
    nbytes = max(nbytes, min_bytes)
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps, device)
    return 2 * nbytes / (ms * 1e-3) / 1e9


def trace(fn: Callable, device=None,
          profile_dir: Optional[str] = None) -> Tuple[float, list]:
    """One call of ``fn()`` under ``torch.profiler``: (total ms, [(name,
    ms)] longest first), by ``self_device_time_total`` of the CUDA
    activity on a CUDA device (nothing counted twice), by
    ``self_cpu_time_total`` of the CPU activity elsewhere; the port's own
    spans (``utils/trace.py``, when on) are left out of the rows.  With
    ``profile_dir`` the trace is also written there as a Chrome trace."""
    import os
    from torch.profiler import ProfilerActivity, profile
    dev = _device(device)
    cuda = dev.type == "cuda"
    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    attr = "self_device_time_total" if cuda else "self_cpu_time_total"
    rows = sorted(((e.key, getattr(e, attr) / 1e3)
                   for e in prof.key_averages() if getattr(e, attr) > 0
                   and not e.key.startswith(_trace.PREFIX)),
                  key=lambda t: -t[1])
    return sum(ms for _, ms in rows), rows
