"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch: ``torch.fft`` in float64 (complex128), one axis at a time
and block by block along axis 0, so a rank can work out the part of a
global spectrum it holds without the whole field in memory.  It imports
nothing of the program and takes nothing the program made: it makes the
input blocks again from the seed (``traffic.field_block``) and reads the
program's outputs only to judge them.

The forward output is held against the reference spectrum of its field;
the backward output against the field itself, which is what the plain
round trip returns (backward norm).  Each is judged by two numbers:

* ``rel_l2``: the L2 norm of the difference over that of the reference;
* ``max_gap``: the largest difference of one element, over the
  reference's root mean square, so one wrong element shows even where
  the L2 norm of 2**27 of them would hide it.
"""
from __future__ import annotations

import math

import torch

ROWS = 32    # rows of axis 0 compared at once


def as_complex128(planes):
    """One real plane as float64, or (re, im) planes as complex128."""
    if len(planes) == 1:
        return planes[0].double()
    return torch.complex(planes[0].double(), planes[1].double())


def forward_reference(block_fn, nblocks: int, kind: str, cols: slice):
    """The forward spectrum of a field over all its axes, restricted to
    ``cols`` of its last axis.  ``block_fn(b)`` gives block b of
    ``nblocks`` along axis 0 (float32 planes, or one real plane for
    ``kind`` "r2c": then the last axis is the half spectrum's)."""
    parts = []
    for b in range(nblocks):
        x = as_complex128(block_fn(b))
        t = (torch.fft.rfft(x, dim=-1) if kind == "r2c"
             else torch.fft.fft(x, dim=-1))
        del x
        t = t[..., cols].contiguous()
        for d in range(1, t.dim() - 1):
            t = torch.fft.fft(t, dim=d)
        parts.append(t)
    t = torch.cat(parts, 0) if len(parts) > 1 else parts[0]
    del parts
    return torch.fft.fft(t, dim=0)


def as_planes(out) -> tuple:
    """The program's output as a tuple of planes (or one real plane):
    a complex tensor, a real tensor, an object with ``re``/``im`` (a
    split complex) or a tuple of planes."""
    if isinstance(out, (tuple, list)):
        return tuple(out)
    if hasattr(out, "re") and hasattr(out, "im"):
        return out.re, out.im
    if torch.is_tensor(out) and out.is_complex():
        return out.real, out.imag
    return (out,)


def compare(out, ref: torch.Tensor) -> dict:
    """``rel_l2`` and ``max_gap`` of the program's output ``out`` against
    ``ref`` (complex128 or float64, on the same device), row block by
    row block.  A shape that differs from the reference's reads inf."""
    planes = as_planes(out)
    if tuple(planes[0].shape) != tuple(ref.shape) or (
            len(planes) == 1) != (not ref.is_complex()):
        return {"rel_l2": math.inf, "max_gap": math.inf}
    num = den = 0.0
    gap = 0.0
    for s in range(0, ref.shape[0], ROWS):
        r = ref[s:s + ROWS]
        p = as_complex128(tuple(q[s:s + ROWS] for q in planes))
        d = (p - r).abs()
        num += float((d * d).sum())
        den += float((r.abs() ** 2).sum())
        gap = max(gap, float(d.max()))
    if not math.isfinite(num) or den == 0.0:
        return {"rel_l2": math.inf, "max_gap": math.inf}
    rms = math.sqrt(den / ref.numel())
    return {"rel_l2": math.sqrt(num / den), "max_gap": gap / rms}


def judge(readings: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every limit, in the limits' order;
    a number missing from ``readings`` fails."""
    out = []
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        out.append((name, v, limit, bool(v <= limit)))
    return out
