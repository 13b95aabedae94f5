"""N-D helpers: apply a batched 1-D split-pair transform along any axis.

Counterpart: ``regent_fft_tpu/ops/nd.py``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def apply_along_axis(fn_1d: Callable, axis: int, xr, xi) -> Pair:
    """Apply a (B, n) -> (B, k) split-pair transform along ``axis``.

    Counterpart: ``regent_fft_tpu/ops/nd.py:23``.
    """
    axis = axis % xr.ndim
    xr = xr.movedim(axis, -1)
    xi = xi.movedim(axis, -1)
    lead = xr.shape[:-1]
    n = xr.shape[-1]
    yr, yi = fn_1d(xr.reshape(-1, n), xi.reshape(-1, n))
    k = yr.shape[-1]
    yr = yr.reshape(*lead, k).movedim(-1, axis).contiguous()
    yi = yi.reshape(*lead, k).movedim(-1, axis).contiguous()
    return yr, yi


def apply_along_axis_real_in(fn_1d: Callable, axis: int, x) -> Pair:
    """Apply a (B, n) real -> (B, k) split-pair r2c transform along ``axis``.

    Counterpart: ``regent_fft_tpu/ops/nd.py:42``.
    """
    axis = axis % x.ndim
    x = x.movedim(axis, -1)
    lead = x.shape[:-1]
    yr, yi = fn_1d(x.reshape(-1, x.shape[-1]))
    k = yr.shape[-1]
    yr = yr.reshape(*lead, k).movedim(-1, axis).contiguous()
    yi = yi.reshape(*lead, k).movedim(-1, axis).contiguous()
    return yr, yi


def apply_along_axis_real_out(fn_1d: Callable, axis: int, xr, xi):
    """Apply a (B, h) split-pair -> (B, n) real c2r transform along
    ``axis``; returns the real array.

    Counterpart: ``regent_fft_tpu/ops/nd.py:60``.
    """
    axis = axis % xr.ndim
    xr = xr.movedim(axis, -1)
    xi = xi.movedim(axis, -1)
    lead = xr.shape[:-1]
    h = xr.shape[-1]
    y = fn_1d(xr.reshape(-1, h), xi.reshape(-1, h))
    return y.reshape(*lead, y.shape[-1]).movedim(-1, axis).contiguous()


def c2c_nd(fns_by_axis: Sequence[Tuple[int, Callable]], xr, xi) -> Pair:
    """Multi-axis C2C: apply each (axis, fn_1d) in turn (the DFTs commute;
    the order matters for speed only).

    Counterpart: ``regent_fft_tpu/ops/nd.py:76``.
    """
    for axis, fn in fns_by_axis:
        xr, xi = apply_along_axis(fn, axis, xr, xi)
    return xr, xi
