"""What a run records, and the reductions the metric readers share.

Each rank of a run returns one record (a dict):

* ``chips``, ``device_name``, ``peak`` (the card's data-sheet rates, or
  None), ``steps``, ``transforms`` (global transforms completed);
* ``setup_s``: the parent process's start to this rank's window start;
* ``window_s``: the window's wall time, ended by a device synchronize;
* ``step_ms``: each step's span between the CUDA events recorded at the
  step boundaries;
* ``enqueue_s``: host seconds inside the benchmark's calls into the port;
* ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over set-up and
  window;
* ``flops_per_step``, ``bytes_per_step``: the global transforms' work
  and ideal bytes (``yardstick``);
* ``launches``: the program's launch counter over the window;
* ``trace``: None, or the reduced profiler trace (``devtrace``).

A reader (``metrics/<name>.py``) defines ``read(recs)`` over the list of
records, one per rank, and returns a number, or None where it finds
nothing to read: then the metric is left out of the line.
"""
from __future__ import annotations

from . import devtrace


def traced(recs) -> bool:
    """Every rank traced its window and saw device operations in it (a
    host run has none, and reports no device metric)."""
    return all(r.get("trace") and r["trace"]["window"] and r["trace"]["ops"]
               for r in recs)


def class_ms_per_step(rec, classes) -> float:
    """Device ms per window step of the operations of ``classes``."""
    us = sum(t - s for _, c, s, t in rec["trace"]["ops"] if c in classes)
    return us * 1e-3 / rec["steps"]


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def busy_s(rec) -> float:
    return devtrace.busy_us(rec["trace"]) * 1e-6


def traced_window_s(rec) -> float:
    ws, we = rec["trace"]["window"]
    return (we - ws) * 1e-6
