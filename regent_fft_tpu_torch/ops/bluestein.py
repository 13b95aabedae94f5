"""Bluestein's chirp-z transform for lengths with large prime factors.

Counterpart: ``regent_fft_tpu/ops/bluestein.py``.  With
nk = (n^2 + k^2 - (k - n)^2) / 2,

    X[k] = c[k] * sum_n (x[n] c[n]) * conj(c[k - n]),
    c[j] = exp(sign * pi*i * j^2 / n),

a linear convolution of a = x*c with h[j] = conj(c[j]), evaluated as a
circular one of length m >= 2n - 1 (``factor.bluestein_pad``): FFT_m(a),
times the kernel spectrum H = FFT_m(h), then the unscaled inverse and 1/m.

The chirp and H are made in float64 numpy at plan time, as in the JAX
package, and go to the plan's device once, when the function is built.
The two inner transforms are the dense pipeline
(``stockham.build_c2c_1d``), or the injected ``inner`` pair: on a CUDA
plan, f32 planes and a power-of-two m in 64..``MAX_LAST_N`` the plan
passes :func:`_inner_kernel_pair`, two ``fft_last`` launches a call.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import Direction
from . import factor as _factor
from . import stockham_kernels as _sk
from . import twiddle as _twiddle
from .stockham import cmul_elem


@functools.lru_cache(maxsize=256)
def _bluestein_tables(n: int, m: int, sign: int, dtype=np.float32):
    """(chirp re, chirp im, H re, H im): c[0:n] and H[0:m], made in float64.

    Counterpart: ``regent_fft_tpu/ops/bluestein.py:39``.
    """
    cr64, ci64 = _twiddle.chirp(n, sign, np.float64)
    c = cr64 + 1j * ci64
    h = np.zeros(m, dtype=np.complex128)
    h[:n] = np.conj(c)
    h[m - n + 1:] = np.conj(c)[1:][::-1]    # h[m-j] = conj(c[j]), j = 1..n-1
    hhat = np.fft.fft(h)
    return (c.real.astype(dtype), c.imag.astype(dtype),
            hhat.real.astype(dtype), hhat.imag.astype(dtype))


def kernel_pair(m: int):
    """(forward, backward) on the last-axis kernel for (B, m) f32 planes,
    or None where ``fft_last`` does not take m (a power of two with
    64 <= m <= ``MAX_LAST_N``).  Each is ``fft_axis_stockham(…, -1, …)``:
    ``fft_last`` on CUDA planes, ``fft_last_plain`` on CPU ones."""
    if m < 64 or m & (m - 1) or m > _sk.MAX_LAST_N:
        return None

    def fwd(zr, zi):
        return _sk.fft_axis_stockham(zr, zi, -1, Direction.FORWARD)

    def inv(zr, zi):
        return _sk.fft_axis_stockham(zr, zi, -1, Direction.BACKWARD)
    return fwd, inv


def _inner_kernel_pair(m: int, device):
    """The inner pair a plan on ``device`` gives Bluestein: :func:`kernel_pair`
    on a CUDA device (its twiddle tables for both signs fetched now), else
    None.  Counterpart: ``regent_fft_tpu/ops/bluestein.py:53``, gated there
    on the TPU backend and ``REGENT_FFT_BLUESTEIN_KERNEL``, which the port
    does not read.
    """
    if device is None or torch.device(device).type != "cuda":
        return None
    pair = kernel_pair(m)
    if pair is not None:
        for d in Direction:
            _sk.device_tables(m, int(d), torch.device(device), _sk.last_stages)
    return pair


def build_bluestein_1d(n: int, direction: Direction, m: int,
                       max_radix: int = _factor.DEFAULT_MAX_RADIX,
                       use_3m: bool = False, inner=None, device=None,
                       dtype: torch.dtype = torch.float32):
    """fn((B, n) re, im) -> (re, im), the unscaled DFT by chirp-z.

    ``inner`` is the (forward, backward) pair of the two length-m
    transforms for f32 planes (:func:`kernel_pair`); without it, and
    for f64 planes, they take the dense pipeline.  The tables for
    ``device`` and ``dtype`` are uploaded here; planes of another device or
    dtype get theirs at their first call.  The function's ``kernel_m`` is m
    when it has the kernel pair.
    Counterpart: ``regent_fft_tpu/ops/bluestein.py:75``.
    """
    from .stockham import build_c2c_1d   # stockham imports this module

    sign = int(direction)
    fwd = build_c2c_1d(m, Direction.FORWARD, max_radix, use_3m)
    inv = build_c2c_1d(m, Direction.BACKWARD, max_radix, use_3m)
    tables = {}

    def upload(dev, dt):
        npd = np.float64 if dt == torch.float64 else np.float32
        tabs = [torch.from_numpy(t).to(dev)[None]
                for t in _bluestein_tables(n, m, sign, npd)]
        tables[(dev, dt)] = (*tabs, float(npd(1.0 / m)))

    if device is not None:
        upload(torch.device(device), dtype)

    def fn(xr, xi):
        if (xr.device, xr.dtype) not in tables:
            upload(xr.device, xr.dtype)
        cr, ci, hr, hi, inv_scale = tables[(xr.device, xr.dtype)]
        f, g = (inner if inner is not None and xr.dtype == torch.float32
                else (fwd, inv))
        ar, ai = cmul_elem(xr, xi, cr, ci)              # a = x * c
        fr, fi = f(F.pad(ar, (0, m - n)), F.pad(ai, (0, m - n)))
        vr, vi = g(*cmul_elem(fr, fi, hr, hi))          # unscaled IFFT_m
        return cmul_elem(vr[:, :n] * inv_scale, vi[:, :n] * inv_scale, cr, ci)
    fn.kernel_m = m if inner is not None else None
    return fn
