"""Spans and counters inside the port.

Spans mark the port's layer boundaries on ``torch.profiler``'s clock:
with tracing on, :func:`span` is a ``torch.profiler.record_function``, so
the span lands in the profiler's Chrome trace as a ``user_annotation``
beside the CUPTI device records, with no store or clock of its own.
Switch it with ``REGENT_FFT_TRACE=1``, read once at import, or with
:func:`set_tracing`.  With tracing off a span is one shared no-op object:
no allocation and no ``record_function``, which costs microseconds even
with no profiler running.  Spans carry no arguments: the profiler's Chrome
trace drops a ``record_function``'s ``args``, so spans join the calls
they sit in, and the benchmark's steps, by their nesting in time.

Every span name starts with ``rft.``:

* ``rft.plan``: the outermost span of one call into a plan
  (``Plan.__call__``/``execute_split``/``execute_real``, the distributed
  plans' calls).  A distributed plan's local cores open it again, nested;
* ``rft.layout.split``/``rft.layout.combine``: the input's split into
  planes and the output's combination; ``rft.layout.nyquist``: the
  Nyquist pack and unpack of the real plans; ``rft.scale``: a norm scale
  applied as a pass of its own;
* ``rft.step.<kind>``: one step of ``plan.run_steps``, and
  ``rft.step.r2c``/``rft.step.c2r`` the real axis;
* ``rft.exchange.pack``/``rft.exchange.a2a``/``rft.exchange.unpack``: a
  distributed plan's all-to-all, its send-buffer copies and the copies
  out of the received buffer;
* ``rft.build``: cold paths (a plan or a kernel table made, the kernel
  library loaded or compiled).

Counters (always on): ``COUNTS["exchange_bytes"]``, the bytes this rank
sends to other ranks through the distributed plans' collectives; the
launch counters ``LAUNCHES``/``LAUNCH_BYTES`` live beside the launches in
``ops/stockham_kernels.py``.

:func:`device_us_by_span` reads an exported Chrome trace back: device
time by the innermost span that holds each operation's launch.
"""
from __future__ import annotations

import os

import torch

PREFIX = "rft."
UNATTRIBUTED = "unattributed"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

ON = False
COUNTS = {"exchange_bytes": 0}


class _Off:
    """The span of tracing off: a shared context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def set_tracing(on: bool):
    """Spans on (``record_function`` annotations) or off (no-ops)."""
    global ON
    ON = bool(on)


def tracing() -> bool:
    return ON


def _init():
    """``REGENT_FFT_TRACE`` as the switch; a malformed value means off."""
    try:
        set_tracing(int(os.environ.get("REGENT_FFT_TRACE", "0")))
    except ValueError:
        set_tracing(False)


def span(name: str):
    """A span named ``name`` (``rft.`` first)."""
    if not ON:
        return _OFF
    return torch.profiler.record_function(name)


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _innermost(spans, launches) -> dict:
    """{key: innermost span name holding its time} for (time, key)
    ``launches`` among one thread's properly nested (start, end, name)
    ``spans``: a sweep with a stack of the open spans."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(launches, key=lambda x: x[0]):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def device_us_by_span(events, window=None) -> dict:
    """{span name: device microseconds} over Chrome trace ``events``
    (``torch.profiler``'s ``export_chrome_trace``, its ``traceEvents``):
    each kernel, memcpy and memset that starts inside ``window`` ([start,
    end] µs, or all of them) goes whole under the innermost ``rft.`` span
    that holds its launch on the launching thread, joined through the
    ``correlation`` id of the ``cuda_runtime``/``cuda_driver`` launch
    record; an operation with no such span or no launch record goes under
    ``"unattributed"``."""
    spans, launches, ops = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e.get("ts", 0.0))
        d = float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                (s, s + d, name))
        elif cat in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = (e.get("pid"), e.get("tid"), s)
        elif cat in DEVICE_CATS:
            if window is None or window[0] <= s < window[1]:
                ops.append(((e.get("args") or {}).get("correlation"), d))
    by_thread = {}
    for c, (pid, tid, t) in launches.items():
        by_thread.setdefault((pid, tid), []).append((t, c))
    where = {}
    for thread, ls in by_thread.items():
        where.update(_innermost(spans.get(thread, ()), ls))
    out = {}
    for c, d in ops:
        name = where.get(c, UNATTRIBUTED)
        out[name] = out.get(name, 0.0) + d
    return out


_init()
