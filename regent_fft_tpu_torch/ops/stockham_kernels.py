"""Stockham butterfly kernels: schedule gates, wrappers and plain versions.

Counterpart: ``regent_fft_tpu/ops/pallas_stockham.py``.  Three hand-written
CUDA kernels (``csrc/stockham.cu``) carry the C2C plan path:

=================  ===================================  =====================
wrapper            replaces (pallas_stockham.py)        plain version
=================  ===================================  =====================
``fft_last``       ``_runner_last`` (:1267)             ``fft_last_plain``
``fft_cols``       ``_runner_cols`` (:787)              ``fft_cols_plain``
``fft_fused2``     ``_runner_fused2`` (:875)            ``fft_fused2_plain``
=================  ===================================  =====================

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; any other device raises.  There is no fallback: a CUDA tensor
never reaches a plain version through a wrapper.  Each wrapper counts its
kernel launches in ``LAUNCHES``.

The plain versions follow the JAX tile (``_stockham_tile`` :709): radix-4
head stages with the ``_packed_tables`` twiddles, then one dense mt-point
DFT product through ``torch.matmul`` at full f32.  The kernels compute the
same DFT with FFMA butterflies all the way down (see the source note in
``csrc/stockham.cu``) from their own float64-generated table
(:func:`_kernel_tables`).

The gates (``kernel_len_ok``, ``fused2_supported``, the length caps) are
the JAX package's, so a plan's step list is the same in both packages.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..dtypes import Direction

Pair = Tuple[torch.Tensor, torch.Tensor]

# The JAX package's gate constants (pallas_stockham.py:48-51, :177, :839).
LANE_TILE = 128
MAX_STOCKHAM_N = 2048
MAX_LAST_N = 2048
MAX_FUSED2_ELEMS = 262144
TAIL_MT = 64          # largest dense tail of the plain tile


# ---------------------------------------------------------------------------
# Schedule helpers (exact copies of the JAX package's, radix-8 off)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1024)
def _stage_radices(n: int) -> Tuple[int, ...]:
    """Radix-4 head stages leaving a tail <= TAIL_MT.

    Counterpart: ``pallas_stockham.py:238`` (``_stage_radices_for`` :210
    with the radix-8 knob off, its default).
    """
    radices = []
    m = n
    while m > TAIL_MT:
        radices.append(4)
        m //= 4
    return tuple(radices)


def _plan_stages(n: int):
    """Head schedule [(radix, sub-length)].  Counterpart: :242."""
    stages = []
    m = n
    for r in _stage_radices(n):
        stages.append((r, m))
        m //= r
    return stages


def _tail_mt(n: int) -> int:
    """Length of the dense tail DFT.  Counterpart: :256."""
    m = n
    for r in _stage_radices(n):
        m //= r
    return m


def kernel_len_ok(n: int, last: bool) -> bool:
    """Can the butterfly kernels run a length-n axis?  Any power of two, or
    mixed radix n = mt * 4**s (mt % 8 == 0), with n % 128 on a last axis
    and n % 8 elsewhere.  Counterpart: ``pallas_stockham.py:263``."""
    if n >= 2 and (n & (n - 1)) == 0:
        return True
    if n < 16 or (n % 128 if last else n % 8):
        return False
    m = n
    while m > TAIL_MT:
        if m % 4:
            return False
        m //= 4
    return m >= 8 and m % 8 == 0


def _fusable_len(n: int, last: bool) -> bool:
    """Counterpart: ``pallas_stockham.py:1233``."""
    if n >= 2 and (n & (n - 1)) == 0:
        return True
    return n >= 128 and kernel_len_ok(n, last)


def fused2_supported(n1: int, n2: int) -> bool:
    """Can the trailing pair (n1, n2) run as one fused kernel?

    Counterpart: ``pallas_stockham.py:1243``.
    """
    return (_fusable_len(n1, False) and _fusable_len(n2, True)
            and n1 * n2 <= MAX_FUSED2_ELEMS
            and n2 >= LANE_TILE
            and n1 >= 16 and n2 >= 16)


def four_step_supported(n: int) -> bool:
    """Last-axis lengths the JAX package runs as the four-step pipeline
    (ROADMAP slice 2).  Counterpart: ``pallas_stockham.py:1068``."""
    if n <= MAX_LAST_N or n & (n - 1):
        return False
    n1 = max(8, n // MAX_LAST_N)
    return n1 <= MAX_STOCKHAM_N and LANE_TILE <= n // n1 <= MAX_LAST_N


def _packed_tables(n: int, sign: int):
    """Head twiddles + tail DFT matrix packed into two (T + mt, mt) planes.

    Rows [0, T) column 0 hold the head-stage twiddles (W^j | W^2j | W^3j
    per radix-4 stage); rows [T, T + mt) hold the mt-point DFT matrix.
    Counterpart: ``pallas_stockham.py:291`` (bit-identical).
    """
    re_parts, im_parts, offsets = [], [], []
    pos = 0
    for r, m in _plan_stages(n):
        h = m // r
        j = np.arange(h, dtype=np.int64)
        offs = []
        for q in range(1, r):
            theta = (2.0 * np.pi * q / m) * j * float(sign)
            re_parts.append(np.cos(theta).astype(np.float32))
            im_parts.append(np.sin(theta).astype(np.float32))
            offs.append((pos, h))
            pos += h
        offsets.append(offs)
    mt = _tail_mt(n)
    head_r = np.zeros((pos, mt), np.float32)
    head_i = np.zeros((pos, mt), np.float32)
    if pos:
        head_r[:, 0] = np.concatenate(re_parts)
        head_i[:, 0] = np.concatenate(im_parts)
    k = np.arange(mt)
    th = 2.0 * np.pi * float(sign) * np.outer(k, k) / mt
    wr = np.concatenate([head_r, np.cos(th).astype(np.float32)], axis=0)
    wi = np.concatenate([head_i, np.sin(th).astype(np.float32)], axis=0)
    return wr, wi, offsets


# ---------------------------------------------------------------------------
# Plain versions: the JAX tile in torch ops (any device, full f32)
# ---------------------------------------------------------------------------
def _bfly4(q, s: float):
    """Radix-4 butterfly across four (re, im) slab pairs.

    Counterpart: ``pallas_stockham.py:334`` (``_bfly_core``, r = 4).
    """
    (q0r, q0i), (q1r, q1i), (q2r, q2i), (q3r, q3i) = q
    t0r, t0i = q0r + q2r, q0i + q2i
    t1r, t1i = q0r - q2r, q0i - q2i
    t2r, t2i = q1r + q3r, q1i + q3i
    t3r, t3i = q1r - q3r, q1i - q3i
    it3r, it3i = -s * t3i, s * t3r
    return [(t0r + t2r, t0i + t2i), (t1r + it3r, t1i + it3i),
            (t0r - t2r, t0i - t2i), (t1r - it3r, t1i - it3i)]


def _stockham_tile_plain(xr, xi, n: int, sign: int) -> Pair:
    """FFT over axis 0 of (n, V) planes: radix-4 head stages, then the
    dense mt-point tail as one full-f32 matmul (the 4M product folded into
    two products on K-concatenated operands, the JAX 'h4' form).

    Counterpart: ``pallas_stockham.py:709`` (``_stockham_tile``, with
    ``_stockham_head`` :2154 and ``_dg_3m`` :2179).
    """
    v = xr.shape[-1]
    wr_np, wi_np, offsets = _packed_tables(n, sign)
    wr = torch.from_numpy(wr_np).to(xr.device)
    wi = torch.from_numpy(wi_np).to(xr.device)
    ar = xr.reshape(1, n, v)
    ai = xi.reshape(1, n, v)
    s = float(sign)
    L = 1
    for (r, m), offs in zip(_plan_stages(n), offsets):
        h = m // r
        ws = [(wr[st:st + hh, :1][None], wi[st:st + hh, :1][None])
              for st, hh in offs]
        q = [(ar[:, j * h:(j + 1) * h], ai[:, j * h:(j + 1) * h])
             for j in range(r)]
        ys = _bfly4(q, s)
        outs = [ys[0]] + [(yr_ * w_r - yi_ * w_i, yr_ * w_i + yi_ * w_r)
                          for (yr_, yi_), (w_r, w_i) in zip(ys[1:], ws)]
        ar = torch.stack([o[0] for o in outs], 0).reshape(r * L, h, v)
        ai = torch.stack([o[1] for o in outs], 0).reshape(r * L, h, v)
        L *= r
    mt = _tail_mt(n)
    t = wr.shape[0] - mt
    tr, ti = wr[t:, :mt], wi[t:, :mt]
    rhs = torch.cat([ar.reshape(L, mt, v), ai.reshape(L, mt, v)], 1)
    yr = torch.matmul(torch.cat([tr, -ti], 1), rhs)      # (L, mt, v)
    yi = torch.matmul(torch.cat([ti, tr], 1), rhs)
    # output index q*L + l
    return (yr.permute(1, 0, 2).reshape(n, v),
            yi.permute(1, 0, 2).reshape(n, v))


def fft_last_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the last axis of (B, n) planes, scale applied.

    Counterpart: ``pallas_stockham.py:1267`` (``_runner_last``).
    """
    n = xr.shape[-1]
    yr, yi = _stockham_tile_plain(xr.T, xi.T, n, sign)
    return (yr.T * scale).contiguous(), (yi.T * scale).contiguous()


def fft_cols_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the middle axis of (P, n, V) planes, scale applied.

    Counterpart: ``pallas_stockham.py:787`` (``_runner_cols``).
    """
    p, n, v = xr.shape
    yr, yi = _stockham_tile_plain(xr.permute(1, 0, 2).reshape(n, p * v),
                                  xi.permute(1, 0, 2).reshape(n, p * v),
                                  n, sign)
    yr = yr.reshape(n, p, v).permute(1, 0, 2) * scale
    yi = yi.reshape(n, p, v).permute(1, 0, 2) * scale
    return yr.contiguous(), yi.contiguous()


def fft_fused2_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along both trailing axes of (P, n1, n2) planes, scale applied.

    Counterpart: ``pallas_stockham.py:875`` (``_runner_fused2``).
    """
    ar, ai = fft_cols_plain(xr, xi, sign)
    p, n1, n2 = xr.shape
    yr, yi = fft_last_plain(ar.reshape(p * n1, n2), ai.reshape(p * n1, n2),
                            sign, scale)
    return yr.reshape(p, n1, n2), yi.reshape(p, n1, n2)


# ---------------------------------------------------------------------------
# Kernel schedule and tables
# ---------------------------------------------------------------------------
def _kernel_stages(n: int) -> Tuple[int, ...]:
    """Butterfly radices of the CUDA tile for length n = odd * 2**k:
    one radix-2 stage when k is odd, radix-4 stages for the rest of the
    power of two, and the odd factor (3, 5 or 7) last, so that every
    stage's Ns (product of the radices before it) is a power of two."""
    odd, k = n, 0
    while odd % 2 == 0:
        odd //= 2
        k += 1
    if odd not in (1, 3, 5, 7) or n < 2:
        raise ValueError(f"no butterfly schedule for n={n}")
    radices = [2] * (k % 2) + [4] * (k // 2)
    if odd > 1:
        radices.append(odd)
    return tuple(radices)


@functools.lru_cache(maxsize=256)
def _kernel_tables(n: int, sign: int) -> np.ndarray:
    """Twiddles of every kernel stage as a (T, 2) f32 (re, im) array.

    Stage (R, Ns) holds exp(sign*2*pi*i*r*k/(Ns*R)) at offset
    (r-1)*Ns + k, r = 1..R-1, k = 0..Ns-1; stages follow each other.  The
    exponent is reduced mod Ns*R in integers and the trig runs in float64,
    rounded once to f32.
    """
    parts = []
    ns = 1
    for r in _kernel_stages(n):
        e = np.outer(np.arange(1, r, dtype=np.int64),
                     np.arange(ns, dtype=np.int64)).ravel() % (ns * r)
        theta = (2.0 * np.pi / (ns * r)) * e.astype(np.float64) * float(sign)
        parts.append(np.stack([np.cos(theta), np.sin(theta)], -1))
        ns *= r
    return np.ascontiguousarray(np.concatenate(parts).astype(np.float32))


_DEVICE_TABLES: dict = {}


def device_tables(n: int, sign: int, device: torch.device):
    """(twiddle tensor on ``device``, ctypes radix array, stage count) for
    the kernels, uploaded once per (n, sign, device); plans fetch theirs
    when they are made."""
    key = (n, sign, device)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        rad = _kernel_stages(n)
        tw = torch.from_numpy(_kernel_tables(n, sign)).to(device)
        hit = (tw, (ctypes.c_int * len(rad))(*rad), len(rad))
        _DEVICE_TABLES[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
LAUNCHES = {"fft_last": 0, "fft_cols": 0, "fft_fused2": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(name: str, *planes) -> bool:
    """True for CUDA planes (checked for the kernel), False for CPU ones."""
    dev = planes[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: planes on {dev}; expected cuda or cpu")
    for p in planes:
        if p.device != dev or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous float32 on "
                             f"one device, got {p.dtype} on {p.device}")
    if planes[0].shape != planes[1].shape:
        raise ValueError(f"{name}: re/im shapes differ")
    return True


def _launch(name: str, fn, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def fft_last(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the last axis of (B, n) f32 planes, scale fused.

    CUDA planes launch ``fft_last_kernel``; CPU planes run
    :func:`fft_last_plain`.  Counterpart: ``pallas_stockham.py:1267``.
    """
    if not _on_cuda("fft_last", xr, xi):
        return fft_last_plain(xr, xi, sign, scale)
    from . import _build
    b, n = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw, rad, k = device_tables(n, sign, xr.device)
    _launch("fft_last", _build.load().fft_last, xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            b, n, sign, scale, tw.data_ptr(), k, rad)
    return yr, yi


def fft_cols(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the middle axis of (P, n, V) f32 planes, scale fused.

    CUDA planes launch ``fft_cols_kernel``; CPU planes run
    :func:`fft_cols_plain`.  Counterpart: ``pallas_stockham.py:787``.
    """
    if not _on_cuda("fft_cols", xr, xi):
        return fft_cols_plain(xr, xi, sign, scale)
    from . import _build
    p, n, v = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw, rad, k = device_tables(n, sign, xr.device)
    _launch("fft_cols", _build.load().fft_cols, xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            p, n, v, sign, scale, tw.data_ptr(), k, rad)
    return yr, yi


def fft_fused2(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along both trailing axes of (P, n1, n2) f32 planes, scale fused.

    CUDA planes launch ``fft_fused2_kernel``; CPU planes run
    :func:`fft_fused2_plain`.  Counterpart: ``pallas_stockham.py:875``.
    """
    if not _on_cuda("fft_fused2", xr, xi):
        return fft_fused2_plain(xr, xi, sign, scale)
    from . import _build
    p, n1, n2 = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw1, rad1, k1 = device_tables(n1, sign, xr.device)
    tw2, rad2, k2 = device_tables(n2, sign, xr.device)
    _launch("fft_fused2", _build.load().fft_fused2, xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            p, n1, n2, sign, scale, tw1.data_ptr(), k1, rad1,
            tw2.data_ptr(), k2, rad2)
    return yr, yi


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def fft_axis_stockham(xr, xi, axis: int, direction: Direction,
                      scale: float = 1.0) -> Pair:
    """FFT along ``axis`` of N-D split planes in one kernel pass.

    The last axis of a rank >= 2 array goes to :func:`fft_last` as (B, n);
    any other axis (and a rank-1 array) to :func:`fft_cols` as
    (pre, n, post).  Counterpart: ``pallas_stockham.py:2735``.
    """
    ndim = xr.ndim
    axis = axis % ndim
    n = xr.shape[axis]
    is_last = axis == ndim - 1 and ndim > 1
    cap = MAX_LAST_N if is_last else MAX_STOCKHAM_N
    if not kernel_len_ok(n, is_last) or n > cap:
        raise ValueError(
            f"stockham path needs power-of-two or mt*4^s length <= {cap}, "
            f"got {n}")
    sign = int(direction)
    shape = xr.shape
    if is_last:
        yr, yi = fft_last(xr.reshape(-1, n), xi.reshape(-1, n), sign,
                          float(scale))
    else:
        pre = int(np.prod(shape[:axis])) if axis else 1
        post = int(np.prod(shape[axis + 1:]))
        yr, yi = fft_cols(xr.reshape(pre, n, post), xi.reshape(pre, n, post),
                          sign, float(scale))
    return yr.reshape(shape), yi.reshape(shape)


def fft_axes2_stockham(xr, xi, direction: Direction,
                       scale: float = 1.0) -> Pair:
    """FFT along the last two axes of N-D split planes in one kernel.

    Counterpart: ``pallas_stockham.py:1251``.
    """
    shape = xr.shape
    n1, n2 = shape[-2], shape[-1]
    if not fused2_supported(n1, n2):
        raise ValueError(f"fused2 unsupported for trailing axes {(n1, n2)}")
    yr, yi = fft_fused2(xr.reshape(-1, n1, n2), xi.reshape(-1, n1, n2),
                        int(direction), float(scale))
    return yr.reshape(shape), yi.reshape(shape)
