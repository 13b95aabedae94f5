"""Rader's algorithm: a prime-length DFT as a cyclic convolution.

Counterpart: ``regent_fft_tpu/ops/rader.py``.  For prime p the
multiplicative group mod p is cyclic with a generator g, so reindexing the
input n = g^-q and the output k = g^r (q, r = 0..p-2) turns the
nonzero-frequency sums into a length-(p - 1) cyclic convolution

    X[g^r] = x[0] + sum_q x[g^-q] * b[r - q (mod p - 1)],
    b[j]   = exp(sign * 2*pi*i * g^j / p),

plus the DC term X[0] = sum_n x[n].  With L = p - 1 smooth the convolution
is two length-L transforms of the dense pipeline
(``stockham.build_c2c_1d``), about half Bluestein's work.

The two reindexings are ``torch.index_select`` with int64 index tensors;
they and the kernel spectrum (a float64 numpy FFT at plan time) go to the
plan's device once, when the function is built.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..dtypes import Direction
from . import factor as _factor
from .stockham import cmul_elem


@functools.lru_cache(maxsize=512)
def primitive_root(p: int) -> int:
    """Smallest generator of the multiplicative group mod prime p.

    Counterpart: ``regent_fft_tpu/ops/rader.py:39``.
    """
    if p == 2:
        return 1
    phi = p - 1
    qs = set(_factor.prime_factors(phi))
    for g in range(2, p):
        if all(pow(g, phi // q, p) != 1 for q in qs):
            return g
    raise ValueError(f"{p} is not prime")


@functools.lru_cache(maxsize=256)
def _rader_tables(p: int, sign: int, dtype=np.float32):
    """(perm_in, gather_back, bhat_re, bhat_im), made in float64 numpy:
    ``x[:, perm_in]`` is the convolution input, ``(x0 + conv)[:,
    gather_back]`` the output bins 1..p-1, and bhat the spectrum of the
    kernel b.  Counterpart: ``regent_fft_tpu/ops/rader.py:52``.
    """
    L = p - 1
    g = primitive_root(p)
    ginv = pow(g, p - 2, p)
    perm_in = np.empty(L, dtype=np.int64)
    k_of_r = np.empty(L, dtype=np.int64)
    v = w = 1
    for q in range(L):
        perm_in[q] = v
        k_of_r[q] = w
        v = (v * ginv) % p
        w = (w * g) % p
    gather_back = np.empty(L, dtype=np.int64)
    gather_back[k_of_r - 1] = np.arange(L, dtype=np.int64)
    ang = 2.0 * np.pi * k_of_r.astype(np.float64) / p
    b = np.exp(1j * sign * ang)
    bhat = np.fft.fft(b)
    return (perm_in, gather_back,
            bhat.real.astype(dtype), bhat.imag.astype(dtype))


def supported(n: int, max_radix: int) -> bool:
    """Rader applies: n prime, n > max_radix, and n - 1 smooth.

    Counterpart: ``regent_fft_tpu/ops/rader.py:84``.
    """
    if n <= max_radix or len(_factor.prime_factors(n)) != 1:
        return False
    return _factor.is_smooth(n - 1, max_radix)


def build_rader_1d(p: int, direction: Direction,
                   max_radix: int = _factor.DEFAULT_MAX_RADIX,
                   use_3m: bool = False, device=None,
                   dtype: torch.dtype = torch.float32):
    """fn((B, p) re, im) -> (re, im), the unscaled prime-length DFT.

    The tables for ``device`` and ``dtype`` (the planes' f32 or f64) are
    uploaded here; planes of another device or dtype get theirs at their
    first call.  Counterpart: ``regent_fft_tpu/ops/rader.py:91``.
    """
    from .stockham import build_c2c_1d   # stockham imports this module

    sign = int(direction)
    L = p - 1
    fwd = build_c2c_1d(L, Direction.FORWARD, max_radix, use_3m)
    inv = build_c2c_1d(L, Direction.BACKWARD, max_radix, use_3m)
    tables = {}

    def upload(dev, dt):
        npd = np.float64 if dt == torch.float64 else np.float32
        perm, back, bhr, bhi = _rader_tables(p, sign, npd)
        tables[(dev, dt)] = (
            torch.from_numpy(perm).to(dev), torch.from_numpy(back).to(dev),
            torch.from_numpy(bhr).to(dev)[None],
            torch.from_numpy(bhi).to(dev)[None], float(npd(1.0 / L)))

    if device is not None:
        upload(torch.device(device), dtype)

    def fn(xr, xi):
        if (xr.device, xr.dtype) not in tables:
            upload(xr.device, xr.dtype)
        perm, back, bhr, bhi, inv_scale = tables[(xr.device, xr.dtype)]
        dcr = xr.sum(1, keepdim=True)
        dci = xi.sum(1, keepdim=True)
        fr, fi = fwd(xr.index_select(1, perm), xi.index_select(1, perm))
        vr, vi = inv(*cmul_elem(fr, fi, bhr, bhi))      # unscaled IFFT_L
        cr = xr[:, :1] + vr * inv_scale
        ci = xi[:, :1] + vi * inv_scale
        return (torch.cat([dcr, cr.index_select(1, back)], 1),
                torch.cat([dci, ci.index_select(1, back)], 1))
    return fn
