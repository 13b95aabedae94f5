"""Fast Hankel transform (FFTLog): scipy.fft.fht/ifht/fhtoffset parity.

Counterpart: ``regent_fft_tpu/ops/fftlog.py``.  For ``a`` sampled on a
log-spaced grid ``r_j = r_c exp(j dln)``, the transform

    A(k) = int_0^inf a(r) J_mu(k r) k dr

is a log-periodic convolution (Talman 1978, Hamilton 2000): one real FFT,
a multiply by Gamma-function coefficients, one inverse real FFT and a
reversal, batched over every leading axis.  Both FFTs are the port's
plans (:func:`~regent_fft_tpu_torch.api.rfft` / ``irfft`` on the caller's
device: on the card ``fft_last_r2c`` for n <= 1024, and the half-length
C2R route on ``fft_last``).  The coefficients are made on the host in
float64 with ``scipy.special.loggamma`` and uploaded once per
(n, dln, mu, offset, bias, direction, device); the data is float32 and
the output float32, as in the JAX package.
"""
from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

__all__ = ["fht", "ifht", "fhtoffset"]

_LN_2 = math.log(2)


def _loggamma(z):
    from scipy.special import loggamma
    return loggamma(z)


def _fhtcoeff(n: int, dln: float, mu: float, offset: float = 0.0,
              bias: float = 0.0, inverse: bool = False) -> np.ndarray:
    """FFTLog frequency-domain coefficients u_m (Hamilton 2000, eq. 18):
    u_m = (2/kr)^{-2 i y_m} 2^q Gamma(xp + i y_m) / Gamma(xm - i y_m),
    xp = (mu+1+q)/2, xm = (mu+1-q)/2, y_m = pi m / (n dln).
    Counterpart: ``regent_fft_tpu/ops/fftlog.py:41``."""
    lnkr, q = float(offset), float(bias)
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.linspace(0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    v = _loggamma(xm + 1j * y)
    u = _loggamma(xp + 1j * y)
    re = u.real - v.real + _LN_2 * q
    im = u.imag + v.imag + 2 * (_LN_2 - lnkr) * y
    u = np.exp(re + 1j * im)
    # the Nyquist coefficient must be real for an exactly
    # length-preserving real-to-real round trip (scipy does the same)
    if n % 2 == 0:
        u.imag[-1] = 0.0
    if not np.isfinite(u[0]):
        # Gamma pole at m=0: the limit 2^q Gamma(xp)/Gamma(xm), which poch
        # evaluates through the negative-integer cases (scipy parity)
        from scipy.special import poch
        u[0] = 2 ** q * poch(xm, xp - xm)
    if np.isinf(u[0]) and not inverse:
        warnings.warn("singular transform; consider changing the bias",
                      stacklevel=3)
        u = np.copy(u)
        u[0] = 0
    elif u[0] == 0 and inverse:
        warnings.warn("singular inverse transform; consider changing "
                      "the bias", stacklevel=3)
        u = np.copy(u)
        u[0] = np.inf
    return u


@functools.lru_cache(maxsize=128)
def _tables(n: int, dln: float, mu: float, offset: float, bias: float,
            inverse: bool, device: str):
    """(coefficient tensor, bias pre- and post-multipliers, warnings) on
    ``device``: ``u`` (``1/conj(u)`` for the inverse) as complex64, the
    bias tables as float32 (None without a bias).  The warnings of
    :func:`_fhtcoeff` are kept and re-issued by every call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        u = _fhtcoeff(n, dln, mu, offset=offset, bias=bias, inverse=inverse)
    cu = torch.from_numpy(u if not inverse else 1.0 / np.conj(u)).to(
        device=device, dtype=torch.complex64)
    pre = post = None
    if bias != 0:
        j_c = (n - 1) / 2
        j = np.arange(n)
        if inverse:
            pre = np.exp(bias * ((j - j_c) * dln + offset))
            post = np.exp(bias * (j - j_c) * dln)
        else:
            pre = np.exp(-bias * (j - j_c) * dln)
            post = np.exp(-bias * ((j - j_c) * dln + offset))
        pre, post = (torch.from_numpy(t).to(device=device,
                                            dtype=torch.float32)
                     for t in (pre, post))
    return cu, pre, post, tuple((w.message, w.category) for w in caught)


def _fhtq(a: torch.Tensor, cu: torch.Tensor, device) -> torch.Tensor:
    """The log-periodic circular convolution core: one r2c, the
    coefficient multiply, one c2r, and a reversal (the output grid runs in
    the opposite log direction).  Counterpart:
    ``regent_fft_tpu/ops/fftlog.py:81``."""
    from ..api import irfft, rfft
    n = a.shape[-1]
    A = rfft(a, device=device) * cu
    return irfft(A, n=n, device=device).flip(-1)


def _transform(a, dln, mu, offset, bias, inverse: bool, device):
    from ..dtypes import as_real
    from ..plan import resolve_device
    dev = resolve_device(device)
    a = as_real(a, dev, torch.float32)
    n = a.shape[-1]
    cu, pre, post, caught = _tables(n, float(dln), float(mu), float(offset),
                                    float(bias), inverse, str(dev))
    for message, category in caught:
        warnings.warn(message, category, stacklevel=3)
    if pre is not None:
        a = a * pre
    out = _fhtq(a, cu, dev)
    if post is not None:
        out = out * post
    return out


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
        device="cuda"):
    """Fast Hankel transform of order ``mu`` on a log-spaced grid
    (``scipy.fft.fht`` parity; batched over leading axes; float32).
    Counterpart: ``regent_fft_tpu/ops/fftlog.py:97``."""
    return _transform(a, dln, mu, offset, bias, False, device)


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
         device="cuda"):
    """Inverse fast Hankel transform (``scipy.fft.ifht`` parity).
    Counterpart: ``regent_fft_tpu/ops/fftlog.py:114``."""
    return _transform(A, dln, mu, offset, bias, True, device)


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Optimal offset for a low-ringing Hankel transform
    (``scipy.fft.fhtoffset`` parity, Hamilton 2000 eq. 20).
    Counterpart: ``regent_fft_tpu/ops/fftlog.py:130``."""
    lnkr, q = float(initial), float(bias)
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2 * dln)
    zp = _loggamma(xp + 1j * y)
    zm = _loggamma(xm + 1j * y)
    arg = (_LN_2 - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return lnkr + (arg - np.round(arg)) * dln
