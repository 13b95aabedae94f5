"""Matmul-form DFT steps for the axes the butterfly kernels do not take.

Counterpart: ``regent_fft_tpu/ops/stockham.py``.  A short axis is one dense
DFT contraction (``direct``); a longer smooth one is a two-factor
Cooley-Tukey pair of contractions with a twiddle between (``mixed2``).
Both run as ``torch.matmul`` at the planes' precision, f32 or f64 (a
complex128 plan), with tables generated in float64 and rounded once to it:
callers on the card keep ``torch.backends.cuda.matmul.allow_tf32`` False
(PyTorch's default).  bf16 planes (complex32) reach these steps cast to
f32 by the plan, as in the JAX package.

:func:`build_c2c_1d` is the general 1-D pipeline on (B, n) planes: one
direct product, the recursive mixed-radix schedule of
``factor.plan_factors``, or for the other lengths Rader's prime-length
convolution (``ops/rader.py``) or Bluestein's chirp-z (``ops/bluestein.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..dtypes import Direction
from . import factor as _factor
from . import twiddle as _twiddle

Pair = Tuple[torch.Tensor, torch.Tensor]


def _tab_dtype(like: torch.Tensor):
    """Numpy table dtype of the planes' precision (f32/f64).
    Counterpart: ``regent_fft_tpu/ops/stockham.py:43``."""
    return np.float64 if like.dtype == torch.float64 else np.float32


def _table(a, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def cmul_mat(ar, ai, br, bi, use_3m: bool = False) -> Pair:
    """Complex matmul of split operands: (ar + i ai) @ (br + i bi).

    4M (four real products) by default; 3M (Karatsuba) when ``use_3m``.
    Counterpart: ``regent_fft_tpu/ops/stockham.py:56``.
    """
    if use_3m:
        t1 = ar @ br
        t2 = ai @ bi
        t3 = (ar + ai) @ (br + bi)
        return t1 - t2, t3 - t1 - t2
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def cmul_elem(ar, ai, br, bi) -> Pair:
    """Elementwise complex multiply of split operands.

    Counterpart: ``regent_fft_tpu/ops/stockham.py:73``.
    """
    return ar * br - ai * bi, ar * bi + ai * br


def direct_dft(xr, xi, n: int, sign: int, use_3m: bool = False) -> Pair:
    """Direct DFT over the last axis of (B, n) planes, one dense product.

    Counterpart: ``regent_fft_tpu/ops/stockham.py:78``.
    """
    dr, di = _twiddle.dft_matrix(n, sign, _tab_dtype(xr))
    return cmul_mat(xr, xi, _table(dr, xr), _table(di, xr), use_3m)


def mixed_radix_fft(xr, xi, n: int, factors, sign: int,
                    use_3m: bool = False) -> Pair:
    """DFT over the last axis of (B, n) planes by recursive dense stages.

    ``factors`` is the radix schedule (largest first, each <= max_radix):
    x[j1*n2 + j2] -> DFT_n1 over j1 -> twiddle W_n^{k1*j2} -> the rest of
    the schedule over j2 -> output index k1 + n1*k2.
    Counterpart: ``regent_fft_tpu/ops/stockham.py:84``.
    """
    if len(factors) == 1:
        return direct_dft(xr, xi, n, sign, use_3m)
    n1 = factors[0]
    n2 = n // n1
    b = xr.shape[0]
    xr = xr.reshape(b, n1, n2)
    xi = xi.reshape(b, n1, n2)
    d1r, d1i = (_table(a, xr) for a in
                _twiddle.dft_matrix(n1, sign, _tab_dtype(xr)))
    # (n1, n1) @ (b, n1, n2); the DFT matrix is symmetric
    ar, ai = cmul_mat(d1r, d1i, xr, xi, use_3m)
    twr, twi = (_table(a, xr) for a in
                _twiddle.twiddle_outer(n1, n2, n, sign, _tab_dtype(xr)))
    ar, ai = cmul_elem(ar, ai, twr, twi)
    cr, ci = mixed_radix_fft(ar.reshape(b * n1, n2), ai.reshape(b * n1, n2),
                             n2, factors[1:], sign, use_3m)
    cr = cr.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    ci = ci.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    return cr, ci


def _dft_last(xr, xi, dr, di, use_3m: bool) -> Pair:
    """Contract the last axis of split planes with the (n, k) matrix d."""
    if use_3m:
        return cmul_mat(xr, xi, dr, di, True)
    # One product on K-concatenated operands, [xr | xi] @ [[dr, di], [-di, dr]]
    # -> [yr | yi] (the JAX package's 'h4' form).
    k = dr.shape[1]
    m = torch.cat([torch.cat([dr, di], 1), torch.cat([-di, dr], 1)], 0)
    y = torch.cat([xr, xi], -1) @ m
    return y[..., :k], y[..., k:]


def direct_dft_axis(xr, xi, axis: int, n: int, sign: int,
                    use_3m: bool = False) -> Pair:
    """Direct DFT along ``axis`` as one dense contraction.

    Counterpart: ``regent_fft_tpu/ops/stockham.py:137``.
    """
    axis = axis % xr.ndim
    dr, di = _twiddle.dft_matrix(n, sign, _tab_dtype(xr))
    xr = xr.movedim(axis, -1)
    xi = xi.movedim(axis, -1)
    yr, yi = _dft_last(xr, xi, _table(dr, xr), _table(di, xr), use_3m)
    return (yr.movedim(-1, axis).contiguous(),
            yi.movedim(-1, axis).contiguous())


def mixed_radix_fft_axis(xr, xi, axis: int, n: int, n1: int, sign: int,
                         use_3m: bool = False) -> Pair:
    """Two-stage Cooley-Tukey along ``axis``: n = n1 * n2.

    x[j1*n2 + j2] -> DFT_n1 over j1 -> twiddle W_n^{k1*j2} -> DFT_n2 over
    j2 -> output index k1 + n1*k2.
    Counterpart: ``regent_fft_tpu/ops/stockham.py:207``.
    """
    axis = axis % xr.ndim
    n2 = n // n1
    xr = xr.movedim(axis, -1)
    xi = xi.movedim(axis, -1)
    lead = xr.shape[:-1]
    xr = xr.reshape(*lead, n1, n2)
    xi = xi.reshape(*lead, n1, n2)
    td = _tab_dtype(xr)
    d1r, d1i = (_table(a, xr) for a in _twiddle.dft_matrix(n1, sign, td))
    d2r, d2i = (_table(a, xr) for a in _twiddle.dft_matrix(n2, sign, td))
    twr, twi = (_table(a, xr) for a in
                _twiddle.twiddle_outer(n1, n2, n, sign, td))
    # stage 1 over j1: (n1, n1) @ (..., n1, n2); the DFT matrix is symmetric
    ar, ai = cmul_mat(d1r, d1i, xr, xi, use_3m)
    ar, ai = ar * twr - ai * twi, ar * twi + ai * twr
    # stage 2 over j2: (..., n1, n2) @ (n2, n2)
    cr, ci = _dft_last(ar, ai, d2r, d2i, use_3m)
    cr = cr.transpose(-1, -2).reshape(*lead, n)
    ci = ci.transpose(-1, -2).reshape(*lead, n)
    return (cr.movedim(-1, axis).contiguous(),
            ci.movedim(-1, axis).contiguous())


def best_two_factor(n: int, max_radix: int = _factor.DEFAULT_MAX_RADIX):
    """Most balanced split n = n1*n2 with both <= max_radix (None if none).

    Counterpart: ``regent_fft_tpu/ops/stockham.py:258``.
    """
    f = int(math.isqrt(n))
    while f >= 2:
        if n % f == 0 and f <= max_radix and n // f <= max_radix:
            return (max(f, n // f), min(f, n // f))
        f -= 1
    return None


def build_c2c_1d(n: int, direction: Direction,
                 max_radix: int = _factor.DEFAULT_MAX_RADIX,
                 use_3m: bool = False, device=None,
                 dtype: torch.dtype = torch.float32,
                 planner: str = "estimate"):
    """fn((B, n) re, im) -> (re, im), an unscaled DFT of each row.

    Dispatches direct / mixed radix / Rader / Bluestein by
    ``factor.plan_factors``.  ``device`` and ``dtype`` are the plan's
    device and plane dtype (f32 or f64): the Rader and Bluestein tables go
    there now, and Bluestein's inner transforms take the last-axis kernel
    when the device is CUDA, the planes f32 and ``fft_last`` takes the
    padded length (``bluestein._inner_kernel_pair``).  ``planner`` is the
    schedule mode of ``factor.schedule`` ("model": the native cost model).
    Counterpart: ``regent_fft_tpu/ops/stockham.py:269``.
    """
    sign = int(direction)
    kind, info = _factor.plan_factors(n, max_radix, planner)
    if kind == "direct":
        return lambda xr, xi: direct_dft(xr, xi, n, sign, use_3m)
    if kind == "mixed":
        return lambda xr, xi: mixed_radix_fft(xr, xi, n, info, sign, use_3m)
    if kind == "rader":
        from . import rader as _rader
        return _rader.build_rader_1d(n, direction, max_radix, use_3m, device,
                                     dtype)
    from . import bluestein as _bluestein
    inner = (_bluestein._inner_kernel_pair(info, device)
             if dtype == torch.float32 else None)
    return _bluestein.build_bluestein_1d(n, direction, info, max_radix,
                                         use_3m, inner, device, dtype)


@functools.lru_cache(maxsize=512)
def schedule_description(n: int,
                         max_radix: int = _factor.DEFAULT_MAX_RADIX,
                         device: str = "cuda") -> str:
    """Human-readable schedule on plans of the device type ``device``,
    for the plan's step lines.

    Counterpart: ``regent_fft_tpu/ops/stockham.py:300``.
    """
    kind, info = _factor.plan_factors(n, max_radix, device=device)
    if kind == "direct":
        return f"direct-dft-{n} (1 matmul)"
    if kind == "mixed":
        stages = " -> ".join(f"radix-{r}" for r in info)
        return f"mixed({n} = {'*'.join(map(str, info))}): {stages}"
    inner = schedule_description(info, max_radix, device)  # rader, bluestein
    return f"{kind}({n}, conv={info}: {inner})"
