"""Verification harness (FFTW's methodology) for the PyTorch port.

Counterpart: ``regent_fft_tpu/utils/verify.py``.  Every check reports a
relative L2 error against an eps-scaled bound; inputs may be numpy arrays,
torch tensors on any device, or :class:`SplitComplex` planes.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..dtypes import SplitComplex


def to_numpy_complex(y) -> np.ndarray:
    """Materialize any output representation as numpy complex128: numpy
    arrays, tensors of any dtype and device (bf16, f32, f64, complex), and
    SplitComplex planes of bf16 (complex32), f32 or f64.

    Counterpart: ``regent_fft_tpu/utils/verify.py:28``.
    """
    if isinstance(y, SplitComplex):
        return (to_numpy_complex(y.re).real
                + 1j * to_numpy_complex(y.im).real)
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu()
        if y.is_complex():
            y = y.to(torch.complex128)
        else:
            y = y.to(torch.float64)
        return y.numpy().astype(np.complex128)
    return np.asarray(y).astype(np.complex128)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| (||a|| when b is zero).

    Counterpart: ``regent_fft_tpu/utils/verify.py:63``.
    """
    a = to_numpy_complex(a).ravel()
    b = to_numpy_complex(b).ravel()
    denom = np.linalg.norm(b)
    if denom == 0:
        return float(np.linalg.norm(a))
    return float(np.linalg.norm(a - b) / denom)


def tolerance(n: int, dtype: str = "complex64") -> float:
    """FFTW-style error bound: 8 * eps * sqrt(log2 N).

    Counterpart: ``regent_fft_tpu/utils/verify.py:72``.
    """
    eps = {"complex32": 2 ** -8, "complex64": 2 ** -23,
           "complex128": 2 ** -52}[dtype]
    return 8.0 * eps * max(1.0, math.sqrt(math.log2(max(n, 2))))


def reference_dft(x, axes=None, sign: int = -1) -> np.ndarray:
    """float64 reference DFT (unscaled in both directions).

    Counterpart: ``regent_fft_tpu/utils/verify.py:82``.
    """
    x = to_numpy_complex(x)
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    if sign == +1:
        return np.conj(np.fft.fftn(np.conj(x), axes=axes))
    return np.fft.fftn(x, axes=axes)


def check_impulse(fft_fn: Callable, n: int, j: int = 1) -> float:
    """FFT of a delta at j == the W^{jk} column (verify-dft.c impulse test).

    Counterpart: ``regent_fft_tpu/utils/verify.py:93``.
    """
    x = np.zeros(n, dtype=np.complex64)
    x[j % n] = 1.0
    y = to_numpy_complex(fft_fn(x))
    k = np.arange(n)
    expect = np.exp(-2j * np.pi * (j % n) * k / n)
    return float(np.linalg.norm(y - expect) / math.sqrt(n))


def check_linearity(fft_fn: Callable, n: int, seed: int = 0) -> float:
    """FFT(a*x + b*y) == a*FFT(x) + b*FFT(y).

    Counterpart: ``regent_fft_tpu/utils/verify.py:103``.
    """
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    a, b = np.complex64(1.3 - 0.4j), np.complex64(-0.7 + 2.1j)
    lhs = to_numpy_complex(fft_fn(a * x + b * y))
    rhs = a * to_numpy_complex(fft_fn(x)) + b * to_numpy_complex(fft_fn(y))
    return rel_l2(lhs, rhs)


def check_shift(fft_fn: Callable, n: int, s: int = 1, seed: int = 0) -> float:
    """FFT(roll(x, s))[k] == FFT(x)[k] * exp(-2*pi*i*s*k/n).

    Counterpart: ``regent_fft_tpu/utils/verify.py:113``.
    """
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    lhs = to_numpy_complex(fft_fn(np.roll(x, s)))
    k = np.arange(n)
    rhs = to_numpy_complex(fft_fn(x)) * np.exp(-2j * np.pi * s * k / n)
    return rel_l2(lhs, rhs)


def verify_plan(plan, x=None, seed: int = 0) -> dict:
    """Golden check of a plan against numpy float64: {'rel_l2', 'tol',
    'ok'} for any kind, axes and norm; ``x`` defaults to a seeded normal
    input (complex64, or float32 for R2C).

    Counterpart: ``regent_fft_tpu/utils/verify.py:128``.
    """
    from ..dtypes import Direction, Kind
    from ..plan import _half_shape

    spec = plan.spec
    rng = np.random.default_rng(seed)
    if spec.kind == Kind.R2C:
        x_in = (rng.standard_normal(spec.shape).astype(np.float32)
                if x is None else x)
        ref = np.fft.rfftn(to_numpy_complex(x_in).real,
                           axes=spec.axes) * _fwd_scale(spec)
    elif spec.kind == Kind.C2R:
        hs = _half_shape(spec)
        x_in = ((rng.standard_normal(hs) + 1j * rng.standard_normal(hs))
                .astype(np.complex64) if x is None else x)
        ref = np.fft.irfftn(to_numpy_complex(x_in),
                            s=[spec.shape[a] for a in spec.axes],
                            axes=spec.axes) * _np_norm_undo(spec)
    else:
        x_in = ((rng.standard_normal(spec.shape)
                 + 1j * rng.standard_normal(spec.shape)).astype(np.complex64)
                if x is None else x)
        xc = to_numpy_complex(x_in)
        if spec.direction == Direction.FORWARD:
            ref = np.fft.fftn(xc, axes=spec.axes)
        else:
            ref = np.fft.ifftn(xc, axes=spec.axes) * spec.logical_n
        ref = ref * _fwd_scale(spec)
    err = rel_l2(plan(x_in), ref)
    tol = tolerance(spec.logical_n, spec.dtype)
    return {"rel_l2": err, "tol": tol, "ok": err <= tol}


def _fwd_scale(spec) -> float:
    """The scale that turns the unscaled DFT into the plan's norm.

    Counterpart: ``regent_fft_tpu/utils/verify.py:164``.
    """
    from ..plan import _norm_scale
    return _norm_scale(spec)


def _np_norm_undo(spec) -> float:
    """numpy's irfftn applies 1/N; this rescales it to the plan's norm.

    Counterpart: ``regent_fft_tpu/utils/verify.py:170``.
    """
    from ..plan import _norm_scale
    return _norm_scale(spec) * spec.logical_n


def check_parseval(fft_fn: Callable, n: int, seed: int = 0) -> float:
    """Parseval: sum |X|^2 == n * sum |x|^2; the relative difference.

    Counterpart: ``regent_fft_tpu/utils/verify.py:176``.
    """
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = to_numpy_complex(fft_fn(x))
    lhs = float(np.sum(np.abs(y) ** 2))
    rhs = float(n * np.sum(np.abs(x) ** 2))
    return abs(lhs - rhs) / rhs
