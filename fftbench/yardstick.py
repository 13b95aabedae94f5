"""The benchmark's frozen arithmetic: work, ideal bytes, peaks, roofline.

Copied from the port's ``utils/flopcount.py`` and ``Plan.bytes_ideal``
and imported from neither, so a change to the program cannot move the
yardstick it is measured by.

* Work: FFTW's ``libbench2/mflops.c`` convention, 5 N log2 N flops per
  complex transform of N points and 2.5 N log2 N per real one, whatever
  the algorithm does, so rates compare across sizes and libraries.
* Ideal bytes: read the input once, write the output once; 8 B per
  complex64 element, 4 B per float32 element (16 and 8 in double).
* Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its full
  700 W: 3350 GB/s of device memory, 67 TFLOP/s FP32 outside the tensor
  cores.  Any other card has no entry and gets no roofline.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

H100_SXM = {"name": "h100-sxm", "hbm_gbps": 3350.0, "f32_tflops": 67.0}

# Name fragments of cards with other rates that also read "H100".
_NOT_SXM = ("pcie", "nvl")

COMPLEX_BYTES = {"complex64": 8, "complex128": 16, "complex32": 4}


def peaks(device_name: str) -> Optional[dict]:
    """The data-sheet rates of the card called ``device_name``, or None."""
    kind = device_name.lower()
    if "h100" in kind and not any(t in kind for t in _NOT_SXM):
        return dict(H100_SXM)
    return None


def transform_flops(shape: Sequence[int], axes: Sequence[int],
                    real: bool) -> float:
    """5 N log2 N over the transformed lengths, times the batch of the
    other axes; half of it for a real transform."""
    n = math.prod(shape[a] for a in axes)
    batch = math.prod(shape) // n
    if n <= 1:
        return 0.0
    f = 5.0 * n * math.log2(n) * batch
    return 0.5 * f if real else f


def half_shape(shape: Sequence[int], axes: Sequence[int]):
    """The half spectrum's shape of a real transform: the last listed
    axis cut to n/2 + 1."""
    out = list(shape)
    out[axes[-1]] = out[axes[-1]] // 2 + 1
    return tuple(out)


def transform_bytes(shape: Sequence[int], axes: Sequence[int], kind: str,
                    dtype: str) -> int:
    """Ideal device-memory traffic of one transform: its input read once
    and its output written once.  A real element counts half a complex
    one; ``kind`` is "c2c", "r2c" or "c2r"."""
    item = COMPLEX_BYTES[dtype]
    n = math.prod(shape)
    if kind == "c2c":
        return 2 * n * item
    return n * item // 2 + math.prod(half_shape(shape, axes)) * item


def least_time_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the flops over the FP32 peak."""
    return max(nbytes / (peak["hbm_gbps"] * 1e9),
               flops / (peak["f32_tflops"] * 1e12))


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least ``q`` percent of the values do not exceed."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The (start, end) stretches of [start, end] that no interval
    covers, in order."""
    out, t = [], start
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]
