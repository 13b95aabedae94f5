"""Chirp-z transform and zoom FFT (scipy.signal.czt / zoom_fft parity).

Counterpart: ``regent_fft_tpu/_czt.py``.  The transform

    y[k] = sum_n x[n] a^{-n} w^{n k},      k = 0..m-1

on a logarithmic spiral (a, w) is one linear convolution by the chirp
factorization ``w^{nk} = w^{n^2/2} w^{k^2/2} w^{-(k-n)^2/2}``, of 5-smooth
length L = ``next_fast_len(n + m - 1)``; both inner transforms are the
port's dense pipeline (``stockham.build_c2c_1d``) in f32, as in the JAX
package, so a CZT launches no kernel.  The chirp tables and the kernel
spectrum are made in float64 numpy at plan time, rounded to f32 and
uploaded to the plan's device once.  The output is complex64.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import Direction, as_split
from .ops import factor as _factor
from .ops.stockham import build_c2c_1d, cmul_elem


@functools.lru_cache(maxsize=128)
def _czt_tables(n: int, m: int, w: complex, a: complex, L: int):
    """Host f32 tables made in f64: u-chirp (n), k-chirp (m), kernel
    spectrum (L).  Counterpart: ``regent_fft_tpu/_czt.py:36``."""
    with np.errstate(over="ignore"):  # overflow is caught and raised below
        j_n = np.arange(n, dtype=np.float64)
        j_m = np.arange(m, dtype=np.float64)
        wl = complex(w)
        al = complex(a)
        # u[n] multiplier: a^{-n} w^{n^2/2}
        un = al ** (-j_n) * wl ** (j_n * j_n / 2.0)
        # output chirp: w^{k^2/2}
        ck = wl ** (j_m * j_m / 2.0)
        # kernel v[j] = w^{-j^2/2}, j = -(n-1) .. (m-1), circular at length L
        v = np.zeros(L, dtype=np.complex128)
        j_pos = np.arange(m, dtype=np.float64)
        v[:m] = wl ** (-(j_pos * j_pos) / 2.0)
        j_neg = np.arange(1, n, dtype=np.float64)
        v[L - (n - 1):] = (wl ** (-(j_neg * j_neg) / 2.0))[::-1]
        vhat = np.fft.fft(v)
        f32 = np.float32
        tabs = (un.real.astype(f32), un.imag.astype(f32),
                ck.real.astype(f32), ck.imag.astype(f32),
                vhat.real.astype(f32), vhat.imag.astype(f32))
    if not all(np.isfinite(t).all() for t in tabs):
        raise ValueError(
            f"czt spiral |w|={abs(wl):.6g}, |a|={abs(al):.6g} overflows "
            f"float32 chirp tables at n={n}, m={m} (the transform computes "
            "in f32; keep |w|, |a| near 1 or shorten the transform)")
    return tabs


class CZT:
    """Plan-style chirp-z transform (``scipy.signal.CZT`` analog) on one
    device.

    Callable on arrays or tensors whose ``axis`` has length ``n``; returns
    the m-point transform along that axis, complex64, on the plan's
    device.  Counterpart: ``regent_fft_tpu/_czt.py:69``.
    """

    def __init__(self, n: int, m: Optional[int] = None,
                 w: Optional[complex] = None, a: complex = 1 + 0j,
                 max_radix: int = _factor.DEFAULT_MAX_RADIX,
                 use_3m: bool = False, device="cuda"):
        from .plan import resolve_device
        if n < 1:
            raise ValueError(f"n must be positive, got {n}")
        m = n if m is None else int(m)
        if m < 1:
            raise ValueError(f"m must be positive, got {m}")
        if w is None:
            w = np.exp(-2j * np.pi / m)
        self.n, self.m, self.w, self.a = int(n), m, complex(w), complex(a)
        self.device = resolve_device(device)
        L = _factor.next_fast_len(self.n + m - 1)
        self._L = L
        self._fwd = build_c2c_1d(L, Direction.FORWARD, max_radix, use_3m,
                                 self.device, torch.float32)
        self._inv = build_c2c_1d(L, Direction.BACKWARD, max_radix, use_3m,
                                 self.device, torch.float32)
        self._tabs = _czt_tables(self.n, m, self.w, self.a, L)
        self._dev_tabs = tuple(torch.from_numpy(t).to(self.device)[None]
                               for t in self._tabs)
        self._scale = float(np.float32(1.0 / L))

    def _core(self, xr, xi):
        """(B, n) f32 planes -> (B, m) planes of the transform."""
        unr, uni, ckr, cki, vhr, vhi = self._dev_tabs
        n, m, L, s = self.n, self.m, self._L, self._scale
        ur, ui = cmul_elem(xr, xi, unr, uni)
        fr, fi = self._fwd(F.pad(ur, (0, L - n)), F.pad(ui, (0, L - n)))
        gr, gi = cmul_elem(fr, fi, vhr, vhi)
        cr, ci = self._inv(gr, gi)
        return cmul_elem(cr[:, :m] * s, ci[:, :m] * s, ckr, cki)

    def __call__(self, x, axis: int = -1):
        """Counterpart: ``regent_fft_tpu/_czt.py:131``."""
        sx = as_split(x, self.device, "complex64")
        axis = axis % sx.re.ndim
        if sx.re.shape[axis] != self.n:
            raise ValueError(f"axis {axis} has length {sx.re.shape[axis]}, "
                             f"planned n={self.n}")
        mr = sx.re.movedim(axis, -1)
        mi = sx.im.movedim(axis, -1)
        lead = mr.shape[:-1]
        yr, yi = self._core(mr.reshape(-1, self.n), mi.reshape(-1, self.n))
        yr = yr.reshape(*lead, self.m).movedim(-1, axis)
        yi = yi.reshape(*lead, self.m).movedim(-1, axis)
        return torch.complex(yr, yi).contiguous()


@functools.lru_cache(maxsize=64)
def _cached_czt(n, m, w, a, device) -> CZT:
    """Bounded plan cache keyed also on the device (frequency sweeps make
    many (w, a) pairs, each plan pins its tables on the card).
    Counterpart: ``regent_fft_tpu/_czt.py:144``."""
    return CZT(n, m, w, a, device=device)


def _length(x, axis: int) -> int:
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    return int(shape[axis])


def czt(x, m: Optional[int] = None, w: Optional[complex] = None,
        a: complex = 1 + 0j, *, axis: int = -1, device="cuda"):
    """One-shot chirp-z transform (``scipy.signal.czt`` semantics).
    Counterpart: ``regent_fft_tpu/_czt.py:150``."""
    from .plan import resolve_device
    n = _length(x, axis)
    m = n if m is None else int(m)
    w = complex(w) if w is not None else complex(np.exp(-2j * np.pi / m))
    dev = str(resolve_device(device))
    return _cached_czt(n, m, w, complex(a), dev)(x, axis=axis)


def _zoom_params(n, fn, m, fs, endpoint):
    """Counterpart: ``regent_fft_tpu/_czt.py:159``."""
    if np.ndim(fn) == 0:
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = (float(v) for v in fn)
    m = n if m is None else int(m)
    step = (f2 - f1) / (m - 1 if endpoint and m > 1 else m)
    w = complex(np.exp(-2j * np.pi * step / fs))
    a = complex(np.exp(2j * np.pi * f1 / fs))
    return m, w, a


class ZoomFFT(CZT):
    """Zoom FFT over the band [f1, f2) (``scipy.signal.ZoomFFT`` analog).
    Counterpart: ``regent_fft_tpu/_czt.py:171``."""

    def __init__(self, n: int, fn, m: Optional[int] = None, *, fs: float = 2,
                 endpoint: bool = False, device="cuda"):
        m, w, a = _zoom_params(n, fn, m, fs, endpoint)
        super().__init__(n, m, w, a, device=device)


def zoom_fft(x, fn, m: Optional[int] = None, *, fs: float = 2,
             endpoint: bool = False, axis: int = -1, device="cuda"):
    """One-shot zoom FFT (``scipy.signal.zoom_fft`` semantics); plans are
    cached per (n, m, w, a, device) like :func:`czt`.
    Counterpart: ``regent_fft_tpu/_czt.py:180``."""
    from .plan import resolve_device
    n = _length(x, axis)
    m, w, a = _zoom_params(n, fn, m, fs, endpoint)
    dev = str(resolve_device(device))
    return _cached_czt(n, m, w, a, dev)(x, axis=axis)
