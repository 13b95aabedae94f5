"""The traced window: torch.profiler over the window, reduced to records.

The window runs under ``torch.profiler`` (CPU and CUDA activity) inside a
``fftbench.window`` annotation; the benchmark's own host spans
(``enqueue.fwd``, ``enqueue.bwd``, ``wait``) are annotations too.  The
Chrome trace is written to a temporary file, read back and reduced to

* ``window``: the annotation's [start, end] in microseconds;
* ``ops``: every device operation that starts in it, as
  [short name, class, start, end] (classes: ``kernel_class``);
* ``spans``: the host spans, as [name, start, end].

Device and host timestamps share the profiler's clock.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

from . import kernel_class, yardstick

WINDOW = "fftbench.window"
SPANS = ("enqueue.fwd", "enqueue.bwd", "wait")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str, traced: bool):
    """A host span of the benchmark: a profiler annotation when traced."""
    if not traced:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def profiler(device):
    """torch.profiler over the host and, on a card, the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def reduce_events(events) -> dict:
    """The window, its device operations and host spans from Chrome
    trace events."""
    window, ops, spans = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e.get("ts", 0.0))
        t = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append([kernel_class.short_name(name),
                        kernel_class.classify(name, cat), s, t])
        elif cat == "user_annotation":
            if name == WINDOW:
                window = [s, t]
            elif name in SPANS:
                spans.append([name, s, t])
    if window is None:
        return {"window": None, "ops": [], "spans": []}
    ws, we = window
    return {"window": window,
            "ops": [o for o in ops if ws <= o[2] < we],
            "spans": [sp for sp in spans if ws <= sp[1] < we]}


def reduce_profile(prof, rank: int) -> dict:
    """Write ``prof``'s Chrome trace to a temporary file, reduce it and
    delete the file."""
    fd, path = tempfile.mkstemp(prefix=f"fftbench-trace{rank}-",
                                suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce_events(events)


def busy_us(trace: dict) -> float:
    """Microseconds of the window in which some device operation ran."""
    ws, we = trace["window"]
    return yardstick.union_length(
        (max(o[2], ws), min(o[3], we)) for o in trace["ops"])


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host span they fall in ("loop" outside all of
    them), in seconds."""
    by_name = {}
    for name, _, s, t in trace["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ws, we = trace["window"]
    idle = yardstick.gaps([(o[2], o[3]) for o in trace["ops"]], ws, we)
    idle.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in idle[:top]:
        mid = 0.5 * (a + b)
        host = next((n for n, s, t in trace["spans"] if s <= mid < t),
                    "loop")
        named.append([host, (b - a) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
