"""Stockham butterfly kernels: schedule gates, wrappers and plain versions.

Counterpart: ``regent_fft_tpu/ops/pallas_stockham.py``.  Twenty-two
hand-written CUDA entry points carry the plan paths.  This module holds
the eleven of the butterfly passes: the three C2C kernels and the
gap-fused pass on f32 planes (complex64) and on bf16 planes (complex32),
and the axis-0 pass, in ``csrc/stockham.cu`` and ``csrc/cols.cu`` (the
mid-axis pass ``fft_cols`` and ``fft_axis0``), and the real-transform pair
in ``csrc/real.cu``:

=========================  ===================================  =======================
wrapper (launch name)      replaces (pallas_stockham.py)        plain version
=========================  ===================================  =======================
``fft_last``               ``_runner_last`` (:1267)             ``fft_last_plain``
(``fft_last``, bf16:
``fft_last_bf16``)
``fft_cols``               ``_runner_cols`` (:787)              ``fft_cols_plain``
(``fft_cols``, ``fft_cols_bf16``)
``fft_fused2``             ``_runner_fused2`` (:875)            ``fft_fused2_plain``
(``fft_fused2``, ``fft_fused2_bf16``)
``fft_axes_gap``           ``_runner_fused2_gap`` (:1127)       ``fft_axes_gap_plain``
(``fft_gap``, ``fft_gap_bf16``)
``fft_axis0``              ``_runner_axis0`` (:739)             ``fft_axis0_plain``
``fft_last_r2c``           ``_runner_last_r2c`` (:2395)         ``fft_last_r2c_plain``
``ifft_last_c2r``          ``_runner_last_c2r`` (:2521)         ``ifft_last_c2r_plain``
=========================  ===================================  =======================

``ops/fourstep.py`` holds nine more (the four-step twiddle pass
``fft_cols_tw``, and on f32 and bf16 planes the leading-axis four-step
stages ``a0fs_a``/``a0fs_b`` and the slab ring
``fft_axis_ring``/``fft_axes2_ring``) and ``ops/pallas_fft.py`` the two
matmul-form kernels (``fft_mm1``, ``fft_mm2``), on this module's launch
helpers and gates.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; any other device, and a plane dtype the kernel does not take,
raises.  There is no fallback: a CUDA tensor never reaches a plain version
through a wrapper.  Each wrapper counts its kernel launches in
``LAUNCHES`` (all twenty-two).  Every two-axis kernel keeps the plane
between its passes in f32, as the TPU kernels keep it in VMEM and the
plain versions keep it: ``fft_fused2``, the gap pass and the fuse_last
ring (both types) in the distributed shared memory of a thread-block
cluster that holds the whole plane (:func:`fused2_cluster`), so none
allocates scratch.

``fft_axis0`` is the FFT along axis 0 of (n, V) f32 planes: the math of
``fft_cols`` with pre = 1, the scale fused as there (``_runner_axis0`` is
unscaled).  The JAX package has no plan route to ``_runner_axis0``; the
port sends every axis-0 step of a rank-2 f32 array to it
(:func:`fft_axis_stockham`), where the JAX plan runs ``_runner_cols`` with
pre = 1.  Both compute the same transform and print the same step line;
bf16 planes keep ``fft_cols_bf16``.  It computes exact f32 and reads
no ``REGENT_FFT_TAIL_PREC``/``REGENT_FFT_A0FS_PREC`` switch: that meets the
bound of every scheme the JAX kernel offers.

The plain versions follow the JAX tile bodies that ``_tile_impl`` (:643)
picks by block I/O and by ``REGENT_FFT_MXU_IMPL`` (:632; :func:`tile_impl`).
f32 blocks take ``_stockham_tile`` (:709): radix-4 head stages with the
``_packed_tables`` twiddles, then one dense mt-point DFT product.  bf16
blocks (complex32) at a length ``mxu_tile_supported`` admits take
``_direct_tile`` (:614, one dense DFT_n product) for n <= 512 under
``direct`` (the default), ``_mxu_tile`` (:452, the four-step in 3M
products) under ``fourstep``, ``_mxu_tile_fs4m`` (:497, the same with the
4M shared-rhs fold) under ``fs4m``, and ``_mxu_tile_tw`` (:566, the
twiddle-folded four-step) otherwise; every other bf16 length takes
``_stockham_tile``.  The plain versions run them on the bf16 input cast
to f32 and round the scaled output to bf16 once.  The gap-fused pass runs
``_stockham_tile`` on both block types.  Every product is ``torch.matmul``
at full f32.  The kernels compute the same DFT with FFMA butterflies all
the way down, for both block types and every ``REGENT_FFT_MXU_IMPL`` (see
the source notes in ``csrc/stockham.cu``), from their own
float64-generated tables
(:func:`_stage_tables`) of their stage lists: :func:`fused2_stages` for
the cluster kernel of ``fft_fused2``, :func:`last_stages` for the
register-resident rows of ``fft_last`` and of the real pair kernels
``fft_last_r2c`` and ``ifft_last_c2r`` (one row body, ``csrc/last.cuh``),
:func:`cols_stages` for the register-resident columns of ``fft_cols``,
``fft_axis0``, the axis ring and the four-step passes (one column body,
``csrc/cols.cuh``).

The gates (``kernel_len_ok``, ``fused2_supported``,
``fused_gap_supported``, the ``r2c_*`` gates, the four-step and ring
gates, the length caps, ``mxu_tile_supported``) are the JAX package's, so
a plan's step list is the same in both packages.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..dtypes import Direction
from ..utils import trace as _trace

Pair = Tuple[torch.Tensor, torch.Tensor]

# The JAX package's gate constants (pallas_stockham.py:48-51, :177, :839).
LANE_TILE = 128
MAX_BLOCK_ELEMS = 262144
MAX_STOCKHAM_N = 2048
MAX_LAST_N = 2048
MAX_FUSED2_ELEMS = MAX_BLOCK_ELEMS
TAIL_MT = 64          # largest dense tail of the plain tile
MAX_REAL_N = 1024     # pallas_stockham.py:2123


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


# The cluster kernel of ``fft_fused2``: one plane per thread-block cluster
# of C CTAs (C a power of two <= 16; 16 is a non-portable size), 512
# threads a CTA, at most 32 values of an axis a thread, so a CTA holds at
# most 16384 complex elements of its plane, in f32, in shared memory
# (csrc/stockham.cu, fft_fused2_kernel).
FUSED2_THREADS = 512
FUSED2_CTA_ELEMS = 16384
FUSED2_MAX_CLUSTER = 16
SMEM_PER_CTA = 232448        # the 227 KB a block of an H100 can use


def fused2_cluster(n1: int, n2: int, planes: int, sms: int = 132) -> int:
    """CTAs per plane (the cluster size C) of ``fft_fused2`` (and of the
    gap pass, whose planes are strided) on ``planes`` (n1, n2) planes over
    a card of ``sms`` SMs: the least power of two
    that leaves each CTA at most ``FUSED2_CTA_ELEMS`` elements, doubled
    (up to the portable 8) while the grid would fill fewer CTAs than the
    card has SMs.  C divides n1, n2 is a multiple of 8*C (n1 is a
    multiple of 16 and n2 of 128 for every admitted pair: the stripe
    width n2/C takes 16-byte loads) and the CTA's shared memory
    (:func:`fused2_smem_bytes`) fits ``SMEM_PER_CTA``; csrc/stockham.cu
    checks the same and refuses anything else."""
    c = 1
    while (n1 * n2 // c > FUSED2_CTA_ELEMS
           or (c < 8 and planes * c < sms)):
        c *= 2
    if (c > FUSED2_MAX_CLUSTER or n1 % c or n2 % (8 * c)
            or fused2_smem_bytes(n1, n2, c) > SMEM_PER_CTA):
        raise ValueError(f"fft_fused2: no cluster for ({n1}, {n2})")
    return c


def fused2_smem_bytes(n1: int, n2: int, c: int) -> int:
    """Shared memory of one CTA of ``fft_fused2`` with cluster size c, in
    f32 (re, im): its n1/c rows of the plane, one pad word every 32, placed
    half their size above the column stripe (n1 x n2/c), which they
    overlap."""
    hn = (n1 // c) * n2
    return 2 * 4 * (hn // 2 + hn + hn // 32)


def fused_gap_supported(n1: int, n2: int) -> bool:
    """Can the (leading, last) axes (n1, n2) run as one gap-fused pass?

    Counterpart: ``pallas_stockham.py:1211``.
    """
    return fused2_supported(n1, n2)


def _four_step_split(n: int):
    """(n1, n2) for the four-step: n1 >= 8, n2 <= 2048.

    Counterpart: ``pallas_stockham.py:1062``.
    """
    n1 = max(8, n // MAX_LAST_N)
    return n1, n // n1


def four_step_supported(n: int) -> bool:
    """Last-axis lengths run as cols+twiddle -> last -> swap (the
    ``stockham4`` step).  Counterpart: ``pallas_stockham.py:1068``."""
    if n <= MAX_LAST_N or n & (n - 1):
        return False
    n1, n2 = _four_step_split(n)
    return n1 <= MAX_STOCKHAM_N and LANE_TILE <= n2 <= MAX_LAST_N


def axis0_dma_supported(n: int, post: int) -> bool:
    """Can the slab-ring leading/mid-axis route take (n, post) planes?

    Counterpart: ``pallas_stockham.py:1559``.
    """
    if not (16 <= n <= MAX_STOCKHAM_N and _fusable_len(n, False)):
        return False
    if post % 512 == 0 and post >= 2048 and (n * 512) <= MAX_BLOCK_ELEMS:
        return True
    return (post % 128 == 0 and 128 <= post <= 2048
            and n * post <= MAX_BLOCK_ELEMS)


def fused2_ring_supported(n1: int, n2: int) -> bool:
    """Can the slab ring run both trailing axes of (n1, n2) planes?

    Counterpart: ``pallas_stockham.py:1602``.
    """
    return (n1 >= 16 and n2 >= LANE_TILE
            and _fusable_len(n1, False) and _fusable_len(n2, True)
            and n1 <= MAX_STOCKHAM_N and n2 <= MAX_STOCKHAM_N
            and n1 * n2 <= MAX_BLOCK_ELEMS)


def _a0fs_split(n: int):
    """Near-square power-of-two split n = r1 * r2 (r1 <= r2) of the
    leading-axis four-step.  Counterpart: ``pallas_stockham.py:1630``."""
    r1 = 1 << ((n.bit_length() - 1) // 2)
    return r1, n // r1


def axis0_fourstep_supported(n: int, post: int, x: int) -> bool:
    """Can the two-pass four-step take a leading/mid axis of length n over
    arrays whose trailing extent is ``post`` and last dim ``x``?

    Counterpart: ``pallas_stockham.py:1691``.
    """
    if n & (n - 1) or n < 64:
        return False
    r1, r2 = _a0fs_split(n)
    mid = post // x if x else 0
    return (r1 >= 8 and 8 <= r2 <= 64
            and x % 128 == 0 and 128 <= x <= 2048
            and post % x == 0 and mid >= 8 and mid % 8 == 0)


def r2c_last_supported(n: int) -> bool:
    """Can the row-pair r2c/c2r kernels run a last axis of length n?

    Counterpart: ``pallas_stockham.py:2126``.
    """
    return 2 <= n <= MAX_REAL_N and n % 2 == 0 and (n & (n - 1)) == 0


def r2c_half_supported(n: int) -> bool:
    """Can the half-length conjugate-even reduction run its n/2-point
    core on the last-axis kernel?  Counterpart: ``pallas_stockham.py:2140``.
    """
    m = n // 2
    return (n % 2 == 0 and (n & (n - 1)) == 0
            and LANE_TILE <= m <= MAX_LAST_N)


def r2c_packed_supported(n: int) -> bool:
    """Does a plan take the Nyquist-packed (n/2-wide) real layout for n?

    Counterpart: ``pallas_stockham.py:2633``.
    """
    return r2c_last_supported(n) and (n // 2) % LANE_TILE == 0


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


# The near-square split (n1 <= n2) of the bf16 four-step tile is the
# leading-axis four-step's.  Counterpart: ``pallas_stockham.py:419``.
_mxu_split = _a0fs_split


def mxu_tile_supported(n: int) -> bool:
    """Counterpart: ``pallas_stockham.py:425``."""
    n1, n2 = _mxu_split(n)
    return (n & (n - 1)) == 0 and n1 >= 8 and n2 >= 8 and n >= 64


@functools.lru_cache(maxsize=256)
def _mxu_tables(n: int, sign: int):
    """Packed DFT_n1 / DFT_n2 / inter-factor twiddle planes of the
    four-step tiles: rows [0, n1) = W1, [n1, n1+n2) = W2,
    [n1+n2, 2*n1+n2) = twiddle(k1, j2); width max(n1, n2).
    Counterpart: ``pallas_stockham.py:431`` (bit-identical)."""
    n1, n2 = _mxu_split(n)
    w = max(n1, n2)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    th1 = 2.0 * np.pi * float(sign) * np.outer(k1, k1) / n1
    th2 = 2.0 * np.pi * float(sign) * np.outer(k2, k2) / n2
    tht = 2.0 * np.pi * float(sign) * np.outer(k1, k2) / n

    def pad(a):
        return np.pad(a, ((0, 0), (0, w - a.shape[1])))
    wr = np.concatenate([pad(np.cos(th1)), pad(np.cos(th2)),
                         pad(np.cos(tht))]).astype(np.float32)
    wi = np.concatenate([pad(np.sin(th1)), pad(np.sin(th2)),
                         pad(np.sin(tht))]).astype(np.float32)
    return wr, wi


@functools.lru_cache(maxsize=64)
def _mxu_tw_tables(n: int, sign: int):
    """Packed planes of the twiddle-folded four-step tile: rows [0, n1) =
    W1 (width n1), rows [n1, n1 + n1*n2) = W2T[k1, k2, j2] = W2[k2, j2] *
    tw[k1, j2] flattened to (k1*n2 + k2, j2).
    Counterpart: ``pallas_stockham.py:539`` (bit-identical)."""
    n1, n2 = _mxu_split(n)
    w = max(n1, n2)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    j2 = np.arange(n2)
    th1 = 2.0 * np.pi * float(sign) * np.outer(k1, k1) / n1
    # (k1, k2, j2)
    tht = 2.0 * np.pi * float(sign) * (
        k2[None, :, None] * j2[None, None, :] / n2
        + k1[:, None, None] * j2[None, None, :] / n)

    def pad(a):
        return np.pad(a, ((0, 0), (0, w - a.shape[1])))
    wr = np.concatenate([pad(np.cos(th1)),
                         pad(np.cos(tht).reshape(n1 * n2, n2))]
                        ).astype(np.float32)
    wi = np.concatenate([pad(np.sin(th1)),
                         pad(np.sin(tht).reshape(n1 * n2, n2))]
                        ).astype(np.float32)
    return wr, wi


@functools.lru_cache(maxsize=64)
def _direct_tables(n: int, sign: int):
    """Dense DFT_n matrix planes of the direct tile.
    Counterpart: ``pallas_stockham.py:607`` (bit-identical)."""
    k = np.arange(n)
    th = 2.0 * np.pi * float(sign) * np.outer(k, k) / n
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


# The bf16 tile body a plan names (``Plan.switches.mxu_impl``) while its
# steps run; unset, :func:`mxu_impl` reads the environment.
_MXU_IMPL: contextvars.ContextVar = contextvars.ContextVar("mxu_impl",
                                                          default=None)


def mxu_impl() -> str:
    """The ``REGENT_FFT_MXU_IMPL`` in force: the value of the innermost
    :func:`mxu_impl_scope`, else the environment's, default "direct".
    Counterpart: ``pallas_stockham.py:632`` (``_mxu_impl``)."""
    impl = _MXU_IMPL.get()
    return impl if impl is not None else os.environ.get(
        "REGENT_FFT_MXU_IMPL", "direct")


@contextlib.contextmanager
def mxu_impl_scope(impl: Optional[str]):
    """Run the plain bf16 bodies under ``impl`` (None: the environment's)
    within the block, in this thread only."""
    token = _MXU_IMPL.set(impl)
    try:
        yield
    finally:
        _MXU_IMPL.reset(token)


def tile_impl(io: str, n: int) -> str:
    """The JAX tile body for block I/O ``io`` ("f32" or "bf16") and length
    n, by name: for bf16 blocks where ``mxu_tile_supported(n)``,
    "direct_tile" (:func:`mxu_impl` "direct" and n <= 512), "mxu_tile_fs4m"
    ("fs4m"), "mxu_tile" ("fourstep") or "mxu_tile_tw" (any other value);
    "stockham_tile" for every other case.
    Counterpart: ``pallas_stockham.py:643`` (``_tile_impl``)."""
    if io == "bf16" and mxu_tile_supported(n):
        impl = mxu_impl()
        if impl == "direct" and n <= 512:
            return "direct_tile"
        if impl == "fs4m":
            return "mxu_tile_fs4m"
        if impl == "fourstep":
            return "mxu_tile"
        return "mxu_tile_tw"
    return "stockham_tile"


# ---------------------------------------------------------------------------
# Plain versions: the JAX tile bodies in torch ops (any device, full f32)
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


def _direct_tile_plain(xr, xi, n: int, sign: int) -> Pair:
    """ONE dense DFT_n product over axis 0 of (n, V) f32 planes, in the 3M
    form.  Counterpart: ``pallas_stockham.py:614`` (``_direct_tile``)."""
    wr, wi = (torch.from_numpy(t).to(xr.device)
              for t in _direct_tables(n, sign))
    t1 = wr @ xr
    t2 = wi @ xi
    t3 = (wr + wi) @ (xr + xi)
    return t1 - t2, t3 - t1 - t2


def _mxu_tile_tw_plain(xr, xi, n: int, sign: int) -> Pair:
    """The twiddle-folded four-step over axis 0 of (n, V) f32 planes: a
    DFT_n1 product on [xr; xi] stacked along j1, then per k1 one product
    with the twiddle-folded DFT_n2 on [br; bi] stacked along j2, then the
    (k1, k2) -> (k2, k1) transpose.
    Counterpart: ``pallas_stockham.py:566`` (``_mxu_tile_tw``)."""
    n1, n2 = _mxu_split(n)
    v = xr.shape[-1]
    wr_all, wi_all = (torch.from_numpy(t).to(xr.device)
                      for t in _mxu_tw_tables(n, sign))
    w1r, w1i = wr_all[:n1, :n1], wi_all[:n1, :n1]
    w2tr = wr_all[n1:, :n2].reshape(n1, n2, n2)       # [k1, k2, j2]
    w2ti = wi_all[n1:, :n2].reshape(n1, n2, n2)
    l1r = torch.cat([w1r, -w1i], 1)                   # (n1, 2 n1)
    l1i = torch.cat([w1i, w1r], 1)
    l2r = torch.cat([w2tr, -w2ti], 2)                 # (n1, n2, 2 n2)
    l2i = torch.cat([w2ti, w2tr], 2)
    acat = torch.cat([xr.reshape(n1, n2 * v), xi.reshape(n1, n2 * v)], 0)
    br = (l1r @ acat).reshape(n1, n2, v)              # (k1, j2, v)
    bi = (l1i @ acat).reshape(n1, n2, v)
    bcat = torch.cat([br, bi], 1)                     # (k1, 2 n2, v)
    dr = torch.bmm(l2r, bcat).transpose(0, 1)         # (k2, k1, v)
    di = torch.bmm(l2i, bcat).transpose(0, 1)
    return dr.reshape(n, v), di.reshape(n, v)


def _mxu_tile_plain(xr, xi, n: int, sign: int) -> Pair:
    """The four-step over axis 0 of (n, V) f32 planes in 3M products: a
    DFT_n1 product along j1, the inter-factor twiddle, a DFT_n2 product
    along j2 (the middle axis), then the (k1, k2) -> (k2, k1) order.
    Counterpart: ``pallas_stockham.py:452`` (``_mxu_tile``)."""
    n1, n2 = _mxu_split(n)
    v = xr.shape[-1]
    wr_all, wi_all = (torch.from_numpy(t).to(xr.device)
                      for t in _mxu_tables(n, sign))
    w1r, w1i = wr_all[:n1, :n1], wi_all[:n1, :n1]
    w2r, w2i = wr_all[n1:n1 + n2, :n2], wi_all[n1:n1 + n2, :n2]
    twr = wr_all[n1 + n2:, :n2, None]
    twi = wi_all[n1 + n2:, :n2, None]

    def cdot(mr, mi, ar, ai):
        t1 = mr @ ar
        t2 = mi @ ai
        t3 = (mr + mi) @ (ar + ai)
        return t1 - t2, t3 - t1 - t2

    br, bi = cdot(w1r, w1i, xr.reshape(n1, n2 * v), xi.reshape(n1, n2 * v))
    br, bi = br.reshape(n1, n2, v), bi.reshape(n1, n2, v)   # (k1, j2, v)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    dr, di = cdot(w2r, w2i, cr, ci)                         # (k1, k2, v)
    return (dr.transpose(0, 1).reshape(n, v),
            di.transpose(0, 1).reshape(n, v))


def _mxu_tile_fs4m_plain(xr, xi, n: int, sign: int) -> Pair:
    """:func:`_mxu_tile_plain` with each complex product in the 4M
    shared-rhs fold: lhs ``[M_r | -M_i]`` and ``[M_i | M_r]`` against one
    rhs ``[v_r; v_i]`` stacked along the contracted axis.
    Counterpart: ``pallas_stockham.py:497`` (``_mxu_tile_fs4m``)."""
    n1, n2 = _mxu_split(n)
    v = xr.shape[-1]
    wr_all, wi_all = (torch.from_numpy(t).to(xr.device)
                      for t in _mxu_tables(n, sign))
    w1r, w1i = wr_all[:n1, :n1], wi_all[:n1, :n1]
    w2r, w2i = wr_all[n1:n1 + n2, :n2], wi_all[n1:n1 + n2, :n2]
    twr = wr_all[n1 + n2:, :n2, None]
    twi = wi_all[n1 + n2:, :n2, None]
    l1r = torch.cat([w1r, -w1i], 1)                   # (n1, 2 n1)
    l1i = torch.cat([w1i, w1r], 1)
    l2r = torch.cat([w2r, -w2i], 1)                   # (n2, 2 n2)
    l2i = torch.cat([w2i, w2r], 1)
    acat = torch.cat([xr.reshape(n1, n2 * v), xi.reshape(n1, n2 * v)], 0)
    br = (l1r @ acat).reshape(n1, n2, v)              # (k1, j2, v)
    bi = (l1i @ acat).reshape(n1, n2, v)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    ccat = torch.cat([cr, ci], 1)                     # (k1, 2 n2, v)
    dr = (l2r @ ccat).transpose(0, 1)                 # (k2, k1, v)
    di = (l2i @ ccat).transpose(0, 1)
    return dr.reshape(n, v), di.reshape(n, v)


_TILES = {"direct_tile": _direct_tile_plain,
          "mxu_tile": _mxu_tile_plain,
          "mxu_tile_fs4m": _mxu_tile_fs4m_plain,
          "mxu_tile_tw": _mxu_tile_tw_plain,
          "stockham_tile": _stockham_tile_plain}


def _io(x) -> str:
    """Block I/O of the planes: "bf16" (complex32) or "f32"."""
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def _last_tile(io: str, xr, xi, sign: int) -> Pair:
    """Unscaled f32 DFT along the last axis of (B, n) planes, by the tile
    body ``tile_impl(io, n)`` picks."""
    n = xr.shape[-1]
    yr, yi = _TILES[tile_impl(io, n)](xr.float().T, xi.float().T, n, sign)
    return yr.T, yi.T


def _cols_tile(io: str, xr, xi, sign: int) -> Pair:
    """Unscaled f32 DFT along the middle axis of (P, n, V) planes."""
    p, n, v = xr.shape
    yr, yi = _TILES[tile_impl(io, n)](
        xr.float().permute(1, 0, 2).reshape(n, p * v),
        xi.float().permute(1, 0, 2).reshape(n, p * v), n, sign)
    return (yr.reshape(n, p, v).permute(1, 0, 2),
            yi.reshape(n, p, v).permute(1, 0, 2))


def _scaled(yr, yi, scale: float, dtype) -> Pair:
    """The scale in f32, then one rounding to the planes' dtype."""
    return ((yr * scale).to(dtype).contiguous(),
            (yi * scale).to(dtype).contiguous())


def fft_last_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the last axis of (B, n) f32 or bf16 planes, scale applied,
    output in the input's dtype.

    Counterpart: ``pallas_stockham.py:1267`` (``_runner_last``).
    """
    return _scaled(*_last_tile(_io(xr), xr, xi, sign), scale, xr.dtype)


def fft_cols_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the middle axis of (P, n, V) f32 or bf16 planes, scale
    applied, output in the input's dtype.

    Counterpart: ``pallas_stockham.py:787`` (``_runner_cols``).
    """
    return _scaled(*_cols_tile(_io(xr), xr, xi, sign), scale, xr.dtype)


def fft_fused2_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along both trailing axes of (P, n1, n2) f32 or bf16 planes,
    scale applied; the intermediate stays f32, as in the TPU kernel's
    VMEM, and the output is rounded once to the input's dtype.

    Counterpart: ``pallas_stockham.py:875`` (``_runner_fused2``).
    """
    io = _io(xr)
    p, n1, n2 = xr.shape
    ar, ai = _cols_tile(io, xr, xi, sign)
    yr, yi = _last_tile(io, ar.reshape(p * n1, n2), ai.reshape(p * n1, n2),
                        sign)
    return _scaled(yr.reshape(p, n1, n2), yi.reshape(p, n1, n2), scale,
                   xr.dtype)


def fft_axis0_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along axis 0 of (n, V) f32 planes, scale applied:
    ``_stockham_tile`` on the whole block.  Counterpart:
    ``pallas_stockham.py:739`` (``_runner_axis0``, unscaled)."""
    n = xr.shape[0]
    return _scaled(*_stockham_tile_plain(xr, xi, n, sign), scale, xr.dtype)


def fft_axes_gap_plain(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along axes 1 and 3 of (B, z, Y, x) f32 or bf16 planes, scale
    applied: ``_stockham_tile`` along z, then along x, on each (z, x) block,
    on either block type; the intermediate stays f32, as in the TPU
    kernel's VMEM, and the output is rounded once to the input's dtype.

    Counterpart: ``pallas_stockham.py:1127`` (``_runner_fused2_gap``).
    """
    b, z, y, x = xr.shape
    ar, ai = _stockham_tile_plain(
        xr.float().permute(1, 0, 2, 3).reshape(z, b * y * x),
        xi.float().permute(1, 0, 2, 3).reshape(z, b * y * x), z, sign)
    # (z, b, y, x) -> x in front
    ar, ai = _stockham_tile_plain(
        ar.reshape(z, b, y, x).permute(3, 0, 1, 2).reshape(x, z * b * y),
        ai.reshape(z, b, y, x).permute(3, 0, 1, 2).reshape(x, z * b * y),
        x, sign)
    # (x, z, b, y) -> (b, z, y, x)
    return _scaled(ar.reshape(x, z, b, y).permute(2, 1, 3, 0),
                   ai.reshape(x, z, b, y).permute(2, 1, 3, 0), scale,
                   xr.dtype)


def fft_last_r2c_plain(x, packed: bool = False, scale: float = 1.0) -> Pair:
    """R2C along the last axis of (B, n) real rows, scale applied:
    (B, n/2+1) planes, or (B, n/2) with the real bin n/2 in bin 0's
    imaginary slot when ``packed``.

    Rows 2p and 2p+1 are the real and imaginary parts of one complex row
    z (an odd last row pairs with zeros); Z = FFT(z) untangles as
    X1[k] = (Z[k] + conj Z[-k]) / 2, X2[k] = (Z[k] - conj Z[-k]) / 2i.
    Counterpart: ``pallas_stockham.py:2395`` (``_runner_last_r2c``).
    """
    b, n = x.shape
    m = n // 2
    if b % 2:
        x = torch.cat([x, x.new_zeros(1, n)], 0)
    zr, zi = _stockham_tile_plain(x[0::2].T, x[1::2].T, n, -1)   # (n, P)
    rev = (-torch.arange(n, device=x.device)) % n
    cr, ci = zr[rev], zi[rev]                                    # Z[-k]
    x1r, x1i = 0.5 * (zr + cr), 0.5 * (zi - ci)
    x2r, x2i = 0.5 * (zi + ci), 0.5 * (cr - zr)
    if packed:
        x1i = torch.cat([x1r[m:m + 1], x1i[1:m]], 0)
        x2i = torch.cat([x2r[m:m + 1], x2i[1:m]], 0)
        w = m
    else:
        w = m + 1
    yr = torch.stack([x1r[:w].T, x2r[:w].T], 1).reshape(-1, w)[:b]
    yi = torch.stack([x1i[:w].T, x2i[:w].T], 1).reshape(-1, w)[:b]
    return (yr * scale).contiguous(), (yi * scale).contiguous()


def ifft_last_c2r_plain(xr, xi, n: int, packed: bool = False,
                        scale: float = 1.0) -> torch.Tensor:
    """n times the inverse of :func:`fft_last_r2c_plain`, scale applied:
    (B, n/2+1) or packed (B, n/2) half spectra -> (B, n) real rows.  The
    imaginary parts of bins 0 and n/2 are taken as zero (numpy ``irfft``).

    Rows 2p and 2p+1 become one complex spectrum Z = X1 + i X2 (for
    k > n/2, Z[k] = conj X1[n-k] + i conj X2[n-k]); one backward transform
    gives row 2p in its real and row 2p+1 in its imaginary part.
    Counterpart: ``pallas_stockham.py:2521`` (``_runner_last_c2r``).
    """
    b = xr.shape[0]
    m = n // 2
    zero = xr.new_zeros(b, 1)
    if packed:
        xr, xi = (torch.cat([xr, xi[:, :1]], 1),
                  torch.cat([zero, xi[:, 1:m], zero], 1))
    else:
        xi = torch.cat([zero, xi[:, 1:m], zero], 1)
    if b % 2:
        xr = torch.cat([xr, torch.zeros_like(xr[:1])], 0)
        xi = torch.cat([xi, torch.zeros_like(xi[:1])], 0)
    x1r, x1i = xr[0::2].T, xi[0::2].T                            # (h, P)
    x2r, x2i = xr[1::2].T, xi[1::2].T
    zr = torch.cat([x1r - x2i, (x1r + x2i)[1:m].flip(0)], 0)     # (n, P)
    zi = torch.cat([x1i + x2r, (x2r - x1i)[1:m].flip(0)], 0)
    vr, vi = _stockham_tile_plain(zr, zi, n, 1)
    y = torch.stack([vr.T, vi.T], 1).reshape(-1, n)[:b]
    return (y * scale).contiguous()


# ---------------------------------------------------------------------------
# Kernel schedule and tables
# ---------------------------------------------------------------------------
def _odd_pow2(n: int) -> Tuple[int, int]:
    """(odd, k) with n = odd * 2**k, for the lengths the butterfly kernels
    schedule (odd 1, 3, 5 or 7); raises for any other."""
    odd, k = n, 0
    while odd % 2 == 0 and odd:
        odd //= 2
        k += 1
    if odd not in (1, 3, 5, 7) or n < 2:
        raise ValueError(f"no butterfly schedule for n={n}")
    return odd, k


def fused2_stages(n: int) -> Tuple[int, ...]:
    """Butterfly radices of the cluster kernel ``fft_fused2`` for length
    n = odd * 2**k: the fewest stages of radix 8 or 4 (ceil(k/3) of them,
    radix 8 first; one radix-2 stage for k = 1), then the odd factor (3, 5
    or 7), so that every stage's Ns is a power of two.  A thread keeps
    whole radix-8 butterflies in registers, so a 512-point axis takes
    three shared-memory exchanges (8, 8, 8) instead of the five of
    radix-4 stages."""
    odd, k = _odd_pow2(n)
    s = -(-k // 3)
    radices = [1 << (k // s + (i < k % s)) for i in range(s)]
    if odd > 1:
        radices.append(odd)
    return tuple(radices)


def last_stages(n: int) -> Tuple[int, ...]:
    """Butterfly radices of the row kernel ``fft_last`` for length
    n = odd * 2**k: radix 16 while four factors of two remain, then the
    rest of the power of two (2, 4 or 8), then the odd factor (3, 5 or 7),
    so that every stage's Ns is a power of two.  A row is held by
    ``n / radices[0]`` threads of 16 values each (one thread for n <= 8), so
    every power of two up to 2048 takes at most two exchanges of shared
    memory (16, 16, 8) and the mixed lengths at most three (1536: 16, 16,
    2, 3).  csrc/last.cuh compiles one kernel instance per admitted
    length with this list (``LAST_CASE``), and csrc/real.cu one per real
    length (``REAL_CASE``); each refuses any other."""
    odd, k = _odd_pow2(n)
    radices = [16] * (k // 4) + ([1 << (k % 4)] if k % 4 else [])
    if odd > 1:
        radices.append(odd)
    return tuple(radices)


def cols_stages(n: int) -> Tuple[int, ...]:
    """Butterfly radices of the column kernel ``fft_cols`` (and
    ``fft_axis0``, the axis ring, ``fft_cols_tw`` and the a0fs stages) for
    length n: the list of :func:`last_stages`, radix 16
    while four factors of two remain, then the rest of the power of two,
    then the odd factor, so every Ns is a power of two.  A column is held
    by n / R0 threads, R0 its first radix (n / 32 from n = 160 on: two
    radix-16 butterflies a thread in the first stages), at most two exchanges of shared memory at
    a power of two up to 2048 and three at 1536.  csrc/cols.cu compiles
    one kernel instance per length ``kernel_len_ok(n, False)`` admits up to
    ``MAX_STOCKHAM_N`` with this list (``COLS_CASE``), csrc/fourstep.cu one
    per power of two it runs (8..2048 for ``fft_cols_tw``, 8..64 for the
    a0fs factors), and each refuses any other."""
    return last_stages(n)


# The slab ring (csrc/ring.cu): 2-D TMA boxes of at most 256 rows, each
# box's place in shared memory 128-byte aligned (the dynamic shared memory
# is asked for 128 bytes more and aligned in the kernel), rows of at least
# 16 bytes; the axis mode's ring at most RING_MAX_K slabs deep.
TMA_BOX_MAX = 256
TMA_MIN_ROW = 16
SMEM_ALIGN = 128
RING_MAX_K = 4
RING_SMEM = SMEM_PER_CTA - 128 - SMEM_ALIGN   # beside barriers and slack
F2_STAGES_BYTES = 4 * (2 + 3 * 12)           # one F2Stages (fused2.cuh)


def _box_rows(n: int) -> int:
    """Rows of a TMA box over an axis of n rows: the largest divisor of n
    up to TMA_BOX_MAX (csrc/ring.cu, box_rows)."""
    b = min(n, TMA_BOX_MAX)
    while n % b:
        b -= 1
    return b


def _round(v: int, a: int) -> int:
    return -(-v // a) * a


def _ring_depth(n: int, c: int, stages: int, es: int) -> int:
    raw = _round(2 * es * n * c, 128)
    xch = 8 * n * c if stages >= 2 else 0
    return min(RING_MAX_K, max(0, RING_SMEM - xch) // raw)


def ring_geometry(n: int, dtype=torch.float32) -> dict:
    """The axis ring's instance for length n on planes of ``dtype``
    (csrc/ring.cu, RingGeo): the column body of ``fft_cols`` (E values a
    thread, the first radix, or twice it where the narrowest tile would
    need more than 512 threads; n/E threads a column; the stages of
    :func:`cols_stages`) on
    tiles of C columns, the widest power of two up to 256 columns and 512
    threads whose ring is at least 2 deep (else the narrowest with 16-byte
    rows), K = ``depth`` slabs of ``raw_bytes`` (the (n, C) re and im tiles
    as the TMA lands them, ``boxes`` boxes of ``box_rows`` rows each) beside
    one f32 exchange buffer of ``exchange_bytes`` (none for one stage), K at
    most RING_MAX_K; ``tx_bytes`` completes a slab's mbarrier."""
    rad = cols_stages(n)
    es = 2 if dtype == torch.bfloat16 else 4
    e = rad[0] if n // rad[0] * (TMA_MIN_ROW // es) <= 512 else 2 * rad[0]
    tpc = n // e
    c = 256
    while c > 1 and tpc * c > 512:
        c //= 2
    cmin = TMA_MIN_ROW // es
    while c > cmin and _ring_depth(n, c, len(rad), es) < 2:
        c //= 2
    c = max(c, cmin)
    raw = _round(2 * es * n * c, 128)
    xch = 8 * n * c if len(rad) >= 2 else 0
    k = _ring_depth(n, c, len(rad), es)
    br = _box_rows(n)
    return dict(E=e, C=c, threads=tpc * c, depth=k, box_rows=br,
                boxes=n // br, raw_bytes=raw, exchange_bytes=xch,
                smem_bytes=k * raw + xch + SMEM_ALIGN,
                tx_bytes=2 * es * n * c)


def axes2_ring_geometry(n1: int, n2: int, planes: int,
                        dtype=torch.float32, sms: int = 132) -> dict:
    """The fuse_last ring's geometry on ``planes`` (n1, n2) planes of
    ``dtype`` (csrc/ring.cu, fft_axes2_ring_kernel): ``fft_fused2``'s cluster
    of C = :func:`fused2_cluster` CTAs, the stripe of w = n2/C columns cut
    into ``subslabs`` sub-slabs of ws columns (2; else 1, else 4: the first
    whose ws makes a TMA box row, at most 256 elements, a multiple of 4
    elements and of 16 bytes), each the TMA boxes (ws, ``box_rows``) of its own
    mbarrier (``tx_bytes``), landing at ``copies``: (sub-slab, part, byte
    offset in the aligned shared memory, bytes a box row, rows) per box;
    bf16 lands in the upper half of its f32 place.  ``smem_bytes``:
    dynamic, with the alignment slack; ``static_bytes``: the stage lists
    and the mbarriers.  ``early``: the sub-slabs that lie below the rows,
    whose next-plane copies go out after the gather."""
    es = 2 if dtype == torch.bfloat16 else 4
    c = fused2_cluster(n1, n2, planes, sms)
    w, h = n2 // c, n1 // c

    def row_ok(ws):
        return ws <= TMA_BOX_MAX and ws % 4 == 0 and ws * es % TMA_MIN_ROW == 0
    sub = next((s_ for s_ in (2, 1, 4) if w % s_ == 0 and row_ok(w // s_)),
               None)
    if sub is None:
        raise ValueError(f"fft_axes2_ring: no sub-slabs for w={w}")
    ws = w // sub
    nw = n1 * ws                       # words of a sub-slab's part
    rb = h * n2 // 2
    part = _round(rb + h * (n2 + n2 // 32), 32)
    br = _box_rows(n1)
    copies = []
    for s_ in range(sub):
        for p_ in range(2):
            base = 4 * (p_ * part + s_ * nw) + (2 * nw if es == 2 else 0)
            for k in range(n1 // br):
                copies.append((s_, p_, base + k * br * ws * es, ws * es, br))
    return dict(C=c, w=w, h=h, subslabs=sub, ws=ws, box_rows=br,
                part_words=part, rows_word=rb,
                smem_bytes=8 * part + SMEM_ALIGN,
                static_bytes=2 * F2_STAGES_BYTES + 8 * sub,
                tx_bytes=2 * nw * es, copies=copies,
                early=[s_ for s_ in range(sub) if (s_ + 1) * nw <= rb])


# The row kernel's blocks: at most LAST_BLOCK threads, whole rows of one
# length (csrc/last.cuh, LastGeo); the real pair kernels take a pair of
# rows where fft_last takes one.
LAST_BLOCK = 128


def last_geometry(n: int) -> Tuple[int, int]:
    """(threads a row, rows a block) of ``fft_last`` at length n: a row is
    n / R0 threads (R0 the first radix of :func:`last_stages`), a block
    LAST_BLOCK // (threads a row) rows, at least one."""
    tpr = n // last_stages(n)[0]
    return tpr, max(1, LAST_BLOCK // tpr)


@functools.lru_cache(maxsize=256)
def _stage_tables(radices: Tuple[int, ...], sign: int) -> np.ndarray:
    """Twiddles of the stages ``radices`` as a (T, 2) f32 (re, im) array.

    Stage (R, Ns) holds exp(sign*2*pi*i*r*k/(Ns*R)) at offset
    (r-1)*Ns + k, r = 1..R-1, k = 0..Ns-1; stages follow each other.  The
    exponent is reduced mod Ns*R in integers and the trig runs in float64,
    rounded once to f32.
    """
    parts = []
    ns = 1
    for r in radices:
        e = np.outer(np.arange(1, r, dtype=np.int64),
                     np.arange(ns, dtype=np.int64)).ravel() % (ns * r)
        theta = (2.0 * np.pi / (ns * r)) * e.astype(np.float64) * float(sign)
        parts.append(np.stack([np.cos(theta), np.sin(theta)], -1))
        ns *= r
    return np.ascontiguousarray(np.concatenate(parts).astype(np.float32))


_DEVICE_TABLES: dict = {}


def device_tables(n: int, sign: int, device: torch.device, stages):
    """(twiddle tensor on ``device``, ctypes radix array, stage count) for
    the kernels, uploaded once per (n, sign, device, stage list); plans
    fetch theirs when they are made.  ``stages`` (:func:`cols_stages`,
    :func:`last_stages` or :func:`fused2_stages`) makes the radix list from
    n."""
    rad = stages(n)
    key = (n, sign, device, rad)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        with _trace.span("rft.build"):
            tw = torch.from_numpy(_stage_tables(rad, sign)).to(device)
        hit = (tw, (ctypes.c_int * len(rad))(*rad), len(rad))
        _DEVICE_TABLES[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
LAUNCHES = {"fft_last": 0, "fft_cols": 0, "fft_fused2": 0,
            "fft_last_r2c": 0, "ifft_last_c2r": 0,
            # the four-step and ring wrappers of ops/fourstep.py
            "fft_cols_tw": 0, "a0fs_a": 0, "a0fs_b": 0,
            "fft_axis_ring": 0, "fft_axes2_ring": 0,
            # the C2C kernels on bf16 planes (complex32)
            "fft_last_bf16": 0, "fft_cols_bf16": 0, "fft_fused2_bf16": 0,
            # the gap-fused pass, and the four-step and ring kernels on bf16
            # planes (ops/fourstep.py)
            "fft_gap": 0, "fft_gap_bf16": 0, "a0fs_a_bf16": 0,
            "a0fs_b_bf16": 0, "fft_axis_ring_bf16": 0,
            "fft_axes2_ring_bf16": 0,
            # the axis-0 pass, and the matmul-form kernels of
            # ops/pallas_fft.py
            "fft_axis0": 0, "fft_mm1": 0, "fft_mm2": 0}
# Bytes by launch name, the same keys: the planes each launch reads once
# plus those it writes once, tables not counted.
LAUNCH_BYTES = dict.fromkeys(LAUNCHES, 0)

# Plane dtypes of the butterfly kernels that take both (all but the real
# pair and fft_cols_tw), and the suffix of the C entry point (and launch
# name) that takes each.
C2C_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_BYTES[k] = 0


def _on_cuda(name: str, *planes, dtypes=(torch.float32,)) -> bool:
    """True for CUDA planes (checked for the kernel), False for CPU ones.
    Planes of a dtype outside ``dtypes`` raise on either device."""
    dev = planes[0].device
    for p in planes:
        if p.dtype not in dtypes:
            raise ValueError(f"{name}: planes of {p.dtype}; the kernel takes "
                             f"{', '.join(map(str, dtypes))}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: planes on {dev}; expected cuda or cpu")
    for p in planes:
        if (p.device != dev or p.dtype != planes[0].dtype
                or not p.is_contiguous()):
            raise ValueError(f"{name}: planes must be contiguous, of one "
                             f"dtype on one device, got {p.dtype} on "
                             f"{p.device}")
    if any(p.shape != planes[0].shape for p in planes):
        raise ValueError(f"{name}: re/im shapes differ")
    return True


def _launch(name: str, fn, device, *args, nbytes: int):
    """Launch C entry ``fn`` on ``device``'s current stream and count
    the launch and its ``nbytes`` (the planes it reads and writes)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    LAUNCH_BYTES[name] += nbytes


def _c2c_entry(name: str, xr):
    """(launch name, bound C function) of a kernel for these planes' dtype
    (``C2C_DTYPES``)."""
    from . import _build
    full = name + C2C_DTYPES[xr.dtype]
    return full, getattr(_build.load(), full)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused2_active_clusters(n1: int, n2: int, c: int, dtype=torch.float32,
                           gap: bool = False):
    """``cudaOccupancyMaxActiveClusters`` of the ``fft_fused2`` kernel (with
    ``gap``, its strided instance that ``fft_gap`` launches) for (n1, n2)
    planes of ``dtype`` in clusters of c CTAs: how many such clusters the
    card holds at once (0: none fits, and the kernel refuses to launch)."""
    from . import _build
    got = _build.load().fft_fused2_clusters(n1, n2, c,
                                            int(dtype == torch.bfloat16),
                                            int(gap))
    if got < 0:
        raise RuntimeError(f"fft_fused2_clusters: CUDA error {-got}")
    return got


def axes2_ring_active_clusters(n1: int, n2: int, c: int,
                               dtype=torch.float32) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the fuse_last ring's instance
    for (n1, n2) planes of ``dtype`` in clusters of c CTAs: at most that
    many clusters walk the planes (0: none fits, and the kernel refuses to
    launch)."""
    from . import _build
    got = _build.load().fft_axes2_ring_clusters(n1, n2, c,
                                                int(dtype == torch.bfloat16))
    if got < 0:
        raise RuntimeError(f"fft_axes2_ring_clusters: CUDA error {-got}")
    return got


def axis_ring_residency(n: int, dtype=torch.float32) -> dict:
    """How the axis ring's instance for length n (planes of ``dtype``) sits
    on the card: resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), columns a tile,
    threads a block, registers a thread, shared bytes a block, ring depth
    (compare :func:`ring_geometry`)."""
    from . import _build
    out = (ctypes.c_int * 6)()
    err = _build.load().fft_axis_ring_residency(
        n, int(dtype == torch.bfloat16), out)
    if err:
        raise RuntimeError(f"fft_axis_ring_residency(n={n}): CUDA error "
                           f"{err}")
    return dict(zip(("blocks_per_sm", "columns_per_block",
                     "threads_per_block", "registers", "smem_bytes",
                     "depth"), out))


def last_residency(n: int, dtype=torch.float32) -> dict:
    """How the ``fft_last`` instance for length n (planes of ``dtype``) sits
    on the card: resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), rows and threads a
    block, registers a thread, shared bytes a block."""
    from . import _build
    out = (ctypes.c_int * 5)()
    err = _build.load().fft_last_residency(n, int(dtype == torch.bfloat16),
                                          out)
    if err:
        raise RuntimeError(f"fft_last_residency(n={n}): CUDA error {err}")
    return dict(zip(("blocks_per_sm", "rows_per_block", "threads_per_block",
                     "registers", "smem_bytes"), out))


def real_residency(n: int, c2r: bool = False) -> dict:
    """How the real pair kernel for length n (``ifft_last_c2r``'s with
    ``c2r``, else ``fft_last_r2c``'s) sits on the card: resident blocks an
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), row pairs and
    threads a block, registers a thread, shared bytes a block."""
    from . import _build
    out = (ctypes.c_int * 5)()
    err = _build.load().fft_last_real_residency(n, int(c2r), out)
    if err:
        raise RuntimeError(f"fft_last_real_residency(n={n}): CUDA error "
                           f"{err}")
    return dict(zip(("blocks_per_sm", "pairs_per_block", "threads_per_block",
                     "registers", "smem_bytes"), out))


def cols_residency(n: int, dtype=torch.float32) -> dict:
    """How the ``fft_cols`` instance for length n (planes of ``dtype``) sits
    on the card: resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), columns and
    threads a block, registers a thread, shared bytes a block."""
    from . import _build
    out = (ctypes.c_int * 5)()
    err = _build.load().fft_cols_residency(n, int(dtype == torch.bfloat16),
                                          out)
    if err:
        raise RuntimeError(f"fft_cols_residency(n={n}): CUDA error {err}")
    return dict(zip(("blocks_per_sm", "columns_per_block",
                     "threads_per_block", "registers", "smem_bytes"), out))


def fourstep_residency(n: int, dtype=torch.float32, tw: bool = True) -> dict:
    """How the four-step column instance for length n sits on the card
    (planes of ``dtype``; ``tw``: the twiddle instance of ``fft_cols_tw``
    and a0fs stage a, else stage b's): resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), columns and
    threads a block, registers a thread, shared bytes a block."""
    from . import _build
    out = (ctypes.c_int * 5)()
    err = _build.load().fft_cols_fs_residency(
        n, int(dtype == torch.bfloat16), int(tw), out)
    if err:
        raise RuntimeError(f"fft_cols_fs_residency(n={n}): CUDA error {err}")
    return dict(zip(("blocks_per_sm", "columns_per_block",
                     "threads_per_block", "registers", "smem_bytes"), out))


def fft_last(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the last axis of (B, n) f32 or bf16 planes, scale fused,
    output in the input's dtype.

    CUDA planes launch ``fft_last_kernel`` (f32) or its bf16 instance
    (counted as ``fft_last_bf16``): rows held in registers, the stages of
    :func:`last_stages`, one kernel instance per length ``kernel_len_ok(n,
    True)`` admits (the C entry refuses any other).  Its accesses are
    element-wise, so any contiguous planes will do.  CPU planes run
    :func:`fft_last_plain`.  Counterpart: ``pallas_stockham.py:1267``.
    """
    if not _on_cuda("fft_last", xr, xi, dtypes=tuple(C2C_DTYPES)):
        return fft_last_plain(xr, xi, sign, scale)
    b, n = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw, rad, k = device_tables(n, sign, xr.device, last_stages)
    _launch(*_c2c_entry("fft_last", xr), xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            b, n, sign, scale, tw.data_ptr(), k, rad,
            nbytes=4 * xr.nbytes)
    return yr, yi


def fft_cols(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along the middle axis of (P, n, V) f32 or bf16 planes, scale
    fused, output in the input's dtype.

    CUDA planes launch ``fft_cols_kernel`` (f32) or its bf16 instance
    (counted as ``fft_cols_bf16``): columns held in registers, the stages
    of :func:`cols_stages`, one kernel instance per length
    ``kernel_len_ok(n, False)`` admits up to ``MAX_STOCKHAM_N`` (the C
    entry refuses any other).  Its accesses are element-wise, so any
    contiguous planes will do.  CPU planes run :func:`fft_cols_plain`.
    Counterpart: ``pallas_stockham.py:787``.
    """
    if not _on_cuda("fft_cols", xr, xi, dtypes=tuple(C2C_DTYPES)):
        return fft_cols_plain(xr, xi, sign, scale)
    p, n, v = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw, rad, k = device_tables(n, sign, xr.device, cols_stages)
    _launch(*_c2c_entry("fft_cols", xr), xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            p, n, v, sign, scale, tw.data_ptr(), k, rad,
            nbytes=4 * xr.nbytes)
    return yr, yi


def fft_fused2(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along both trailing axes of (P, n1, n2) f32 or bf16 planes,
    scale fused, output in the input's dtype.

    CUDA planes launch ``fft_fused2_kernel`` (f32) or its bf16 instance
    (counted as ``fft_fused2_bf16``): one plane per cluster of
    :func:`fused2_cluster` CTAs, the f32 intermediate in the cluster's
    shared memory, so each element crosses device memory once each way and
    nothing is allocated beside the output.  The C entry refuses a cluster
    size the card cannot hold (:func:`fused2_active_clusters` 0) and this
    raises.  CPU planes run :func:`fft_fused2_plain`.  Counterpart:
    ``pallas_stockham.py:875``.
    """
    if not _on_cuda("fft_fused2", xr, xi, dtypes=tuple(C2C_DTYPES)):
        return fft_fused2_plain(xr, xi, sign, scale)
    p, n1, n2 = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    c = fused2_cluster(n1, n2, p, _sm_count(xr.device))
    tw1, rad1, k1 = device_tables(n1, sign, xr.device, fused2_stages)
    tw2, rad2, k2 = device_tables(n2, sign, xr.device, fused2_stages)
    _launch(*_c2c_entry("fft_fused2", xr), xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            p, n1, n2, c, sign, scale,
            tw1.data_ptr(), k1, rad1, tw2.data_ptr(), k2, rad2,
            nbytes=4 * xr.nbytes)
    return yr, yi


def fft_axes_gap(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along axes 1 and 3 of (B, z, Y, x) f32 or bf16 planes, scale
    fused, output in the input's dtype.

    CUDA planes launch the strided instance of ``fft_fused2_kernel`` (f32,
    counted as ``fft_gap``, or bf16, ``fft_gap_bf16``): each (b, y) plane,
    whose rows are y*x elements apart, on one cluster of
    :func:`fused2_cluster` CTAs over the b*y planes, the f32 intermediate
    in the cluster's shared memory, so nothing is allocated beside the
    output.  The C entry refuses a cluster size the card cannot hold and
    this raises.  CPU planes run :func:`fft_axes_gap_plain`.  Counterpart:
    ``pallas_stockham.py:1127``.
    """
    if not _on_cuda("fft_gap", xr, xi, dtypes=tuple(C2C_DTYPES)):
        return fft_axes_gap_plain(xr, xi, sign, scale)
    b, z, y, x = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    c = fused2_cluster(z, x, b * y, _sm_count(xr.device))
    tw1, rad1, k1 = device_tables(z, sign, xr.device, fused2_stages)
    tw2, rad2, k2 = device_tables(x, sign, xr.device, fused2_stages)
    _launch(*_c2c_entry("fft_gap", xr), xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            b, z, y, x, c, sign, scale,
            tw1.data_ptr(), k1, rad1, tw2.data_ptr(), k2, rad2,
            nbytes=4 * xr.nbytes)
    return yr, yi


def fft_axis0(xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """FFT along axis 0 of (n, V) f32 planes, scale fused.

    CUDA planes launch ``fft_cols_kernel<float>`` through its own C entry
    ``fft_axis0`` (counted as ``fft_axis0``); CPU planes run
    :func:`fft_axis0_plain`.  Counterpart: ``pallas_stockham.py:739``.
    """
    if not _on_cuda("fft_axis0", xr, xi):
        return fft_axis0_plain(xr, xi, sign, scale)
    from . import _build
    n, v = xr.shape
    if not kernel_len_ok(n, False) or n > MAX_STOCKHAM_N:
        raise ValueError(f"fft_axis0: no kernel schedule for n={n}")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw, rad, k = device_tables(n, sign, xr.device, cols_stages)
    _launch("fft_axis0", _build.load().fft_axis0, xr.device,
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            n, v, sign, scale, tw.data_ptr(), k, rad,
            nbytes=4 * xr.nbytes)
    return yr, yi


def fft_last_r2c(x, packed: bool = False, scale: float = 1.0) -> Pair:
    """R2C along the last axis of (B, n) real f32 rows, scale fused:
    (B, n/2+1) planes, or (B, n/2) Nyquist-packed when ``packed``.

    CUDA rows launch ``fft_last_r2c_kernel``: row pairs held in registers,
    the stages of :func:`last_stages`, one kernel instance per length
    :func:`r2c_last_supported` admits.  CPU rows run
    :func:`fft_last_r2c_plain`.  Counterpart: ``pallas_stockham.py:2395``.
    """
    if not _on_cuda("fft_last_r2c", x):
        return fft_last_r2c_plain(x, packed, scale)
    from . import _build
    b, n = x.shape
    w = n // 2 if packed else n // 2 + 1
    yr, yi = x.new_empty((b, w)), x.new_empty((b, w))
    tw, rad, k = device_tables(n, -1, x.device, last_stages)
    _launch("fft_last_r2c", _build.load().fft_last_r2c, x.device,
            x.data_ptr(), yr.data_ptr(), yi.data_ptr(), b, n, int(packed),
            scale, tw.data_ptr(), k, rad, nbytes=x.nbytes + 2 * yr.nbytes)
    return yr, yi


def ifft_last_c2r(xr, xi, n: int, packed: bool = False,
                  scale: float = 1.0) -> torch.Tensor:
    """n times the inverse R2C of (B, n/2+1) (or packed (B, n/2)) f32
    half-spectrum planes -> (B, n) real rows, scale fused.

    CUDA planes launch ``ifft_last_c2r_kernel`` (the row-pair body of
    :func:`fft_last_r2c`); CPU planes run :func:`ifft_last_c2r_plain`.
    Counterpart: ``pallas_stockham.py:2521``.
    """
    if not _on_cuda("ifft_last_c2r", xr, xi):
        return ifft_last_c2r_plain(xr, xi, n, packed, scale)
    from . import _build
    b = xr.shape[0]
    y = xr.new_empty((b, n))
    tw, rad, k = device_tables(n, 1, xr.device, last_stages)
    _launch("ifft_last_c2r", _build.load().ifft_last_c2r, xr.device,
            xr.data_ptr(), xi.data_ptr(), y.data_ptr(), b, n, int(packed),
            scale, tw.data_ptr(), k, rad, nbytes=2 * xr.nbytes + y.nbytes)
    return y


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def fft_axis_stockham(xr, xi, axis: int, direction: Direction,
                      scale: float = 1.0) -> Pair:
    """FFT along ``axis`` of N-D split planes in one kernel pass.

    The last axis of a rank >= 2 array goes to :func:`fft_last` as (B, n);
    axis 0 of a rank-2 f32 array to :func:`fft_axis0`; any other axis (and
    a rank-1 array) to :func:`fft_cols` as (pre, n, post).
    Counterpart: ``pallas_stockham.py:2735`` (whose axis 0 of a rank-2
    array takes ``_runner_cols``).
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
    elif ndim == 2 and xr.dtype == torch.float32:
        yr, yi = fft_axis0(xr, xi, sign, float(scale))
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


def fft_axes_gap_stockham(xr, xi, direction: Direction,
                          scale: float = 1.0) -> Pair:
    """FFT along axes -3 and -1 of N-D split planes in one kernel pass.

    Counterpart: ``pallas_stockham.py:1216``.
    """
    shape = tuple(xr.shape)
    if len(shape) < 3:
        raise ValueError("gap-fused pass needs rank >= 3")
    z, y, x = shape[-3:]
    if not fused_gap_supported(z, x):
        raise ValueError(f"gap-fused unsupported for axes {(z, x)}")
    b = int(np.prod(shape[:-3])) if len(shape) > 3 else 1
    yr, yi = fft_axes_gap(xr.reshape(b, z, y, x), xi.reshape(b, z, y, x),
                          int(direction), float(scale))
    return yr.reshape(shape), yi.reshape(shape)


def fft_last_r2c_stockham(x, padded: bool = False, packed: bool = False,
                          scale: float = 1.0) -> Pair:
    """R2C along the last axis of an N-D real f32 array in one kernel pass.

    Returns the split (..., n/2+1) half spectrum; with ``padded`` the
    lane-padded (..., n) planes, bins 0..n/2 and exact zeros above (the
    wrapper copies the kernel's narrow planes into zeroed ones); or with
    ``packed``
    (which wins over ``padded``, as in the JAX package) the (..., n/2)
    layout whose bin 0 carries the real bin n/2 in its imaginary slot.
    Counterpart: ``pallas_stockham.py:2638``.
    """
    shape = tuple(x.shape)
    n = shape[-1]
    if not r2c_last_supported(n):
        raise ValueError(f"kernel r2c path needs even power-of-two n <= "
                         f"{MAX_REAL_N}, got {n}")
    yr, yi = fft_last_r2c(x.reshape(-1, n), packed, float(scale))
    if padded and not packed:
        planes = yr.new_zeros((2,) + yr.shape[:-1] + (n,))
        planes[0, :, :yr.shape[-1]] = yr
        planes[1, :, :yi.shape[-1]] = yi
        yr, yi = planes
    out = shape[:-1] + (yr.shape[-1],)
    return yr.reshape(out), yi.reshape(out)


def ifft_last_c2r_stockham(xr, xi, n: int, packed: bool = False,
                           scale: float = 1.0) -> torch.Tensor:
    """n times the inverse of :func:`fft_last_r2c_stockham`: split
    (..., n/2+1) planes, lane-padded (..., n) planes (the bins above n/2
    are ignored; the wrapper copies out the n/2+1 it reads) or, with
    ``packed``, (..., n/2) planes -> (..., n) real, in one kernel pass.
    Counterpart: ``pallas_stockham.py:2690``.
    """
    if not r2c_last_supported(n):
        raise ValueError(f"kernel c2r path needs even power-of-two n <= "
                         f"{MAX_REAL_N}, got {n}")
    shape = tuple(xr.shape)
    w = n // 2 if packed else n // 2 + 1
    if shape[-1] != w and (packed or shape[-1] != n):
        raise ValueError(f"c2r of n={n} takes {w} bins "
                         f"{'(packed)' if packed else f'or {n} (padded)'}, "
                         f"got {shape}")
    if shape[-1] != w:
        xr, xi = xr[..., :w].contiguous(), xi[..., :w].contiguous()
    y = ifft_last_c2r(xr.reshape(-1, w), xi.reshape(-1, w), n, packed,
                      float(scale))
    return y.reshape(shape[:-1] + (n,))
