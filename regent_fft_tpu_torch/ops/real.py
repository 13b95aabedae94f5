"""Real-input (r2c) and real-output (c2r) 1-D transforms by conjugate-even
packing, on (B, n) planes.

Counterpart: ``regent_fft_tpu/ops/real.py``.  For even n the n reals pack
as n/2 complex points z[m] = x[2m] + i*x[2m+1]; one half-length complex
FFT and an O(n) untangle give the half spectrum.  Odd n runs the full
complex transform of (x + 0i) and keeps bins 0..n//2.

``cfft`` / ``cinv`` inject the half-length complex core: the plan passes
the butterfly kernel there (``stockham_kernels.fft_axis_stockham``), so
this reduction runs one kernel pass on the card; otherwise the core is
``stockham.build_c2c_1d``'s general pipeline, Rader and Bluestein
included, built for the plan's ``device`` and plane ``dtype``.

Every function is unscaled (DFT / n-times-inverse-DFT); the plan applies
the norm once.  Each carries its complex core's ``kernel_m`` (Bluestein's
inner length on ``fft_last``, or None) for the plan's table prefetch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dtypes import Direction
from . import factor as _factor
from . import twiddle as _twiddle
from .stockham import build_c2c_1d, cmul_elem


def _untangle_table(n: int, like: torch.Tensor):
    dt = np.float64 if like.dtype == torch.float64 else np.float32
    wr, wi = _twiddle.halfcomplex_untangle(n, dt)
    return (torch.from_numpy(wr).to(like.device),
            torch.from_numpy(wi).to(like.device))


def build_r2c_1d(n: int, max_radix: int = _factor.DEFAULT_MAX_RADIX,
                 use_3m: bool = False, cfft=None, device=None,
                 dtype: torch.dtype = torch.float32):
    """fn((B, n) real) -> ((B, n//2+1), (B, n//2+1)) split half spectrum.

    Counterpart: ``regent_fft_tpu/ops/real.py:28``.
    """
    if n == 1:
        return lambda x: (x, torch.zeros_like(x))
    if n % 2:
        full = build_c2c_1d(n, Direction.FORWARD, max_radix, use_3m, device,
                            dtype)
        h = n // 2 + 1

        def fn_odd(x):
            yr, yi = full(x, torch.zeros_like(x))
            return yr[:, :h].contiguous(), yi[:, :h].contiguous()
        fn_odd.kernel_m = getattr(full, "kernel_m", None)
        return fn_odd

    m = n // 2
    if cfft is None:
        cfft = build_c2c_1d(m, Direction.FORWARD, max_radix, use_3m, device,
                            dtype)

    def fn(x):
        wr, wi = _untangle_table(n, x)
        z = x.reshape(x.shape[0], m, 2)
        zr, zi = cfft(z[..., 0].contiguous(), z[..., 1].contiguous())
        # Z[k] for k = 0..m (k = m wraps to Z[0]) and Z[(m-k) mod m]
        zk_r = torch.cat([zr, zr[:, :1]], 1)
        zk_i = torch.cat([zi, zi[:, :1]], 1)
        zm_r = torch.cat([zr[:, :1], zr[:, 1:].flip(1), zr[:, :1]], 1)
        zm_i = -torch.cat([zi[:, :1], zi[:, 1:].flip(1), zi[:, :1]], 1)
        # Xe = (Z[k] + conj Z[m-k]) / 2, Xo = -i/2 (Z[k] - conj Z[m-k])
        xe_r = 0.5 * (zk_r + zm_r)
        xe_i = 0.5 * (zk_i + zm_i)
        xo_r = 0.5 * (zk_i - zm_i)
        xo_i = -0.5 * (zk_r - zm_r)
        # X = Xe + w^k Xo
        tr, ti = cmul_elem(xo_r, xo_i, wr[None], wi[None])
        return xe_r + tr, xe_i + ti
    fn.kernel_m = getattr(cfft, "kernel_m", None)
    return fn


def build_c2r_1d(n: int, max_radix: int = _factor.DEFAULT_MAX_RADIX,
                 use_3m: bool = False, cinv=None, device=None,
                 dtype: torch.dtype = torch.float32):
    """fn((B, n//2+1) split half spectrum) -> (B, n) real, n times the
    inverse.  The imaginary parts of bins 0 and n/2 are ignored, as in
    numpy's ``irfft``.

    Counterpart: ``regent_fft_tpu/ops/real.py:75``.
    """
    if n == 1:
        return lambda xr, xi: xr
    if n % 2:
        full = build_c2c_1d(n, Direction.BACKWARD, max_radix, use_3m, device,
                            dtype)
        h = n // 2 + 1

        def fn_odd(xr, xi):
            # the full spectrum by Hermitian symmetry
            fr = torch.cat([xr, xr[:, 1:h].flip(1)], 1)
            fi = torch.cat([xi, -xi[:, 1:h].flip(1)], 1)
            return full(fr, fi)[0]
        fn_odd.kernel_m = getattr(full, "kernel_m", None)
        return fn_odd

    m = n // 2
    if cinv is None:
        cinv = build_c2c_1d(m, Direction.BACKWARD, max_radix, use_3m, device,
                            dtype)

    def fn(xr, xi):
        wr, wi = _untangle_table(n, xr)
        xi = xi.clone()
        xi[:, 0] = 0.0
        xi[:, m] = 0.0
        xkr, xki = xr[:, :m], xi[:, :m]                   # X[k], k < m
        xmr = xr[:, 1:m + 1].flip(1)                      # X[m-k]
        xmi = -xi[:, 1:m + 1].flip(1)                     # conj
        xe_r = 0.5 * (xkr + xmr)
        xe_i = 0.5 * (xki + xmi)
        # Xo = (X[k] - conj X[m-k]) / 2 * w^-k
        xo_r, xo_i = cmul_elem(0.5 * (xkr - xmr), 0.5 * (xki - xmi),
                               wr[None, :m], -wi[None, :m])
        # Z = Xe + i Xo; V = unscaled IDFT_m(Z); y_even = 2 Vr, y_odd = 2 Vi
        vr, vi = cinv((xe_r - xo_i).contiguous(), (xe_i + xo_r).contiguous())
        return torch.stack([2.0 * vr, 2.0 * vi], -1).reshape(xr.shape[0], n)
    fn.kernel_m = getattr(cinv, "kernel_m", None)
    return fn
