"""Spectral estimation (``scipy.signal`` parity): periodogram, welch, csd,
coherence, spectrogram, on the port's plans.

Counterpart: ``regent_fft_tpu/spectral.py``.  One shared machinery: the
segments as an unfold view, a per-segment detrend, the window, ONE
batched R2C plan (C2C for complex or two-sided input) over every segment
on the caller's ``device``, scaled cross or auto products and the segment
average.  Semantics follow ``scipy.signal`` (defaults, density and
spectrum scaling, one-sided doubling, Welch's median-bias correction).

The median average sorts the segments and averages the two middle ones
for an even count, as ``jnp.median`` and scipy do (``torch.median`` would
return the lower of the two).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .api import fft, rfft
from .plan import resolve_device
from .signal import _f32, _get_window, _tensor

__all__ = ["periodogram", "welch", "csd", "coherence", "spectrogram"]


def _detrend_segments(segs: torch.Tensor, detrend) -> torch.Tensor:
    """Per-segment detrend along the last axis ('constant' | 'linear' |
    False); closed-form least squares for 'linear'.
    Counterpart: ``regent_fft_tpu/spectral.py:26``."""
    if detrend is False or detrend is None:
        return segs
    if detrend == "constant":
        return segs - segs.mean(-1, keepdim=True)
    if detrend == "linear":
        n = segs.shape[-1]
        tc = np.arange(n) - (n - 1) / 2.0
        denom = float((tc * tc).sum()) or 1.0
        t = _f32(tc, segs)
        mean = segs.mean(-1, keepdim=True)
        slope = (segs * t).sum(-1, keepdim=True) / denom
        return segs - mean - slope * t
    raise ValueError("detrend must be 'constant', 'linear', or False")


def _median_bias(n: int) -> float:
    """Bias of the median of n chi^2_2 variables relative to the mean
    (scipy.signal._spectral_py._median_bias).
    Counterpart: ``regent_fft_tpu/spectral.py:44``."""
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def _spectral_helper(x, y, fs, window, nperseg, noverlap, nfft, detrend,
                     return_onesided, scaling, axis, mode="psd",
                     device="cuda"):
    """Framed cross-spectrum core shared by all estimators.

    Returns ``(freqs, t, Pxy)`` with ``Pxy`` laid out ``(..., nseg,
    nfreq)``.  ``mode='psd'`` applies the conj(X)*Y product;
    ``mode='stft'`` returns the scaled segment spectra themselves.
    Counterpart: ``regent_fft_tpu/spectral.py:51``.
    """
    dev = resolve_device(device)
    same = y is x or y is None
    x = _tensor(x, dev)
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    cplx = x.is_complex()
    if not same:
        y = _tensor(y, dev)
        if y.ndim != x.ndim:
            raise ValueError(f"rank mismatch: {x.ndim} vs {y.ndim}")
        ym = torch.movedim(y, axis % y.ndim, -1)
        if xm.shape[:-1] != ym.shape[:-1]:
            raise ValueError("x and y must match on non-transform axes: "
                             f"{tuple(x.shape)} vs {tuple(y.shape)}")
        # scipy zero-pads the shorter input along the transform axis
        n = max(xm.shape[-1], ym.shape[-1])
        xm = F.pad(xm, (0, n - xm.shape[-1]))
        ym = F.pad(ym, (0, n - ym.shape[-1]))
        cplx = cplx or y.is_complex()
    n = xm.shape[-1]

    nperseg = 256 if nperseg is None else int(nperseg)
    nperseg = min(nperseg, n)  # scipy clamps (with a warning)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    win = _get_window(window, nperseg)
    step = nperseg - noverlap
    nseg = (n - nperseg) // step + 1
    winj = _f32(win, xm)

    onesided = bool(return_onesided) and not cplx

    def spectra(a):
        fr = a.unfold(-1, nperseg, step)            # (..., nseg, nperseg)
        fr = fr.to(torch.complex64 if cplx else torch.float32)
        fr = _detrend_segments(fr, detrend) * winj
        if nfft > nperseg:
            fr = F.pad(fr, (0, nfft - nperseg))
        return (rfft(fr, axis=-1, device=device) if onesided
                else fft(fr, axis=-1, device=device))

    X = spectra(xm)
    Y = X if same else spectra(ym)

    if scaling == "density":
        scale = 1.0 / (fs * float((win * win).sum()))
    elif scaling == "spectrum":
        scale = 1.0 / float(win.sum()) ** 2
    else:
        raise ValueError("scaling must be 'density' or 'spectrum'")

    if mode == "stft":
        P = X * float(np.float32(np.sqrt(scale)))
    else:
        P = X.conj() * Y * float(np.float32(scale))
        if onesided:
            # the Nyquist bin (even nfft) is not doubled
            P[..., 1:(None if nfft % 2 else -1)] *= 2.0

    freqs = (np.arange(nfft // 2 + 1) * (fs / nfft) if onesided
             else np.fft.fftfreq(nfft, 1.0 / fs))
    t = (np.arange(nseg) * step + nperseg / 2.0) / fs
    return freqs, t, P


def _median(v: torch.Tensor, dim: int) -> torch.Tensor:
    """The median along ``dim``: the middle value, or the mean of the two
    middle values for an even count (``jnp.median``, numpy, scipy)."""
    s = torch.sort(v, dim=dim).values
    n = v.shape[dim]
    hi = s.narrow(dim, n // 2, 1)
    if n % 2 == 0:
        hi = 0.5 * (s.narrow(dim, n // 2 - 1, 1) + hi)
    return hi.squeeze(dim)


def _average_segments(P: torch.Tensor, average: str) -> torch.Tensor:
    """Counterpart: ``regent_fft_tpu/spectral.py:140``."""
    if average == "mean":
        return P.mean(-2)
    if average == "median":
        bias = _median_bias(P.shape[-2])
        if P.is_complex():
            med = torch.complex(_median(P.real, -2), _median(P.imag, -2))
        else:
            med = _median(P, -2)
        return med / bias
    raise ValueError("average must be 'mean' or 'median'")


def csd(x, y, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
        noverlap: Optional[int] = None, nfft: Optional[int] = None,
        detrend="constant", return_onesided: bool = True,
        scaling: str = "density", axis: int = -1, average: str = "mean",
        device="cuda"):
    """Cross power spectral density ``Pxy`` by Welch's method
    (``scipy.signal.csd`` semantics).  Returns ``(f, Pxy)``.
    Counterpart: ``regent_fft_tpu/spectral.py:155``."""
    freqs, _, P = _spectral_helper(x, y, fs, window, nperseg, noverlap, nfft,
                                   detrend, return_onesided, scaling, axis,
                                   device=device)
    P = _average_segments(P, average)
    return freqs, torch.movedim(P, -1, axis % P.ndim)


def welch(x, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          detrend="constant", return_onesided: bool = True,
          scaling: str = "density", axis: int = -1, average: str = "mean",
          device="cuda"):
    """Power spectral density by Welch's method (``scipy.signal.welch``
    semantics).  Returns ``(f, Pxx)`` with ``Pxx`` real.
    Counterpart: ``regent_fft_tpu/spectral.py:167``."""
    freqs, Pxy = csd(x, x, fs, window, nperseg, noverlap, nfft, detrend,
                     return_onesided, scaling, axis, average, device)
    return freqs, Pxy.real


def periodogram(x, fs: float = 1.0, window="boxcar",
                nfft: Optional[int] = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, device="cuda"):
    """Periodogram PSD estimate (``scipy.signal.periodogram`` semantics):
    Welch with one full-length segment.  Returns ``(f, Pxx)``.
    Counterpart: ``regent_fft_tpu/spectral.py:179``."""
    x = _tensor(x, resolve_device(device))
    n = x.shape[axis % x.ndim]
    if nfft is not None and nfft < n:
        # scipy truncates the signal to nfft in this case
        x = x.narrow(axis % x.ndim, 0, nfft)
        n, nfft = nfft, None
    return welch(x, fs, window, nperseg=n, noverlap=0, nfft=nfft,
                 detrend=detrend, return_onesided=return_onesided,
                 scaling=scaling, axis=axis, device=device)


def coherence(x, y, fs: float = 1.0, window="hann",
              nperseg: Optional[int] = None, noverlap: Optional[int] = None,
              nfft: Optional[int] = None, detrend="constant",
              axis: int = -1, device="cuda"):
    """Magnitude-squared coherence ``|Pxy|^2 / (Pxx Pyy)``
    (``scipy.signal.coherence`` semantics).  Returns ``(f, Cxy)``.
    Counterpart: ``regent_fft_tpu/spectral.py:197``."""
    freqs, Pxx = welch(x, fs, window, nperseg, noverlap, nfft, detrend,
                       axis=axis, device=device)
    _, Pyy = welch(y, fs, window, nperseg, noverlap, nfft, detrend,
                   axis=axis, device=device)
    _, Pxy = csd(x, y, fs, window, nperseg, noverlap, nfft, detrend,
                 axis=axis, device=device)
    return freqs, Pxy.abs() ** 2 / (Pxx * Pyy)


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: Optional[int] = None,
                noverlap: Optional[int] = None, nfft: Optional[int] = None,
                detrend="constant", return_onesided: bool = True,
                scaling: str = "density", axis: int = -1,
                mode: str = "psd", device="cuda"):
    """Spectrogram (``scipy.signal.spectrogram`` semantics): per-segment
    spectra with the frequency axis before time.  Returns ``(f, t, Sxx)``
    with ``Sxx`` shaped ``(..., nfreq, nseg)``.
    Counterpart: ``regent_fft_tpu/spectral.py:213``."""
    x = _tensor(x, resolve_device(device))
    n = x.shape[axis % x.ndim]
    nperseg_eff = min(256 if nperseg is None else int(nperseg), n)
    if noverlap is None:
        noverlap = nperseg_eff // 8
    if mode == "psd":
        freqs, t, P = _spectral_helper(x, x, fs, window, nperseg_eff,
                                       noverlap, nfft, detrend,
                                       return_onesided, scaling, axis,
                                       device=device)
        S = P.real
    elif mode in ("complex", "magnitude"):
        freqs, t, Z = _spectral_helper(x, x, fs, window, nperseg_eff,
                                       noverlap, nfft, detrend,
                                       return_onesided, scaling, axis,
                                       mode="stft", device=device)
        S = Z.abs() if mode == "magnitude" else Z
    else:
        raise ValueError("mode must be 'psd', 'complex', or 'magnitude'")
    return freqs, t, S.transpose(-1, -2)
