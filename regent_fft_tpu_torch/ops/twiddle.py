"""Twiddle-factor and DFT-matrix tables (numpy only).

The port's own copy of ``regent_fft_tpu/ops/twiddle.py``: every table is
computed in float64 with exact integer reduction of the exponent and
rounded once to the storage dtype, so table error never exceeds 0.5 ulp.
Tables are (re, im) pairs, the split layout the kernels use.
"""
from __future__ import annotations

import functools

import numpy as np


def _exp_table(exponent: np.ndarray, denom: int, sign: int, dtype):
    """exp(sign * 2*pi*i * exponent / denom), computed in float64.

    Counterpart: ``regent_fft_tpu/ops/twiddle.py:19``.
    """
    e = np.mod(exponent.astype(np.int64), denom)
    theta = (2.0 * np.pi / denom) * e.astype(np.float64) * float(sign)
    return np.cos(theta).astype(dtype), np.sin(theta).astype(dtype)


@functools.lru_cache(maxsize=1024)
def dft_matrix(n: int, sign: int, dtype=np.float32):
    """Dense DFT matrix D[j, k] = exp(sign*2*pi*i*j*k/n) as an (re, im) pair.

    Counterpart: ``regent_fft_tpu/ops/twiddle.py:31``.
    """
    jk = np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64))
    return _exp_table(jk, n, sign, dtype)


@functools.lru_cache(maxsize=1024)
def twiddle_outer(n_rows: int, n_cols: int, denom: int, sign: int,
                  dtype=np.float32):
    """Cooley-Tukey twiddles T[a, b] = exp(sign*2*pi*i*a*b/denom).

    Counterpart: ``regent_fft_tpu/ops/twiddle.py:43``.
    """
    ab = np.outer(np.arange(n_rows, dtype=np.int64),
                  np.arange(n_cols, dtype=np.int64))
    return _exp_table(ab, denom, sign, dtype)


@functools.lru_cache(maxsize=1024)
def chirp(n: int, sign: int, dtype=np.float32):
    """Bluestein chirp c[j] = exp(sign*pi*i*j^2/n) as an (re, im) pair, with
    j^2 reduced mod 2n in integers (exp has period 2n in j^2).

    Counterpart: ``regent_fft_tpu/ops/twiddle.py:54``.
    """
    j = np.arange(n, dtype=np.int64)
    return _exp_table(np.mod(j * j, 2 * n), 2 * n, sign, dtype)


@functools.lru_cache(maxsize=1024)
def halfcomplex_untangle(n: int, dtype=np.float32):
    """w^k = exp(-2*pi*i*k/n) for k = 0..n/2 as an (re, im) pair: the r2c
    untangle of an n/2-point FFT of reals packed z[m] = x[2m] + i*x[2m+1].

    Counterpart: ``regent_fft_tpu/ops/twiddle.py:66``.
    """
    k = np.arange(n // 2 + 1, dtype=np.int64)
    return _exp_table(k, n, -1, dtype)
