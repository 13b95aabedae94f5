"""Four-step and slab-ring kernels: wrappers, plain versions and entries.

Counterpart: the large-axis kernels of ``regent_fft_tpu/ops/pallas_stockham.py``.
Three TPU kernels become nine CUDA entry points (the stages and the ring
on f32 and on bf16 planes), each counted under its own name in
``stockham_kernels.LAUNCHES`` (a ``_bf16`` suffix for bf16 planes):

==========================  ==================================  ======================
wrapper (launch name)       replaces (pallas_stockham.py)       plain version
==========================  ==================================  ======================
``fft_cols_tw``             ``_runner_cols_tw`` (:1010)         ``fft_cols_tw_plain``
``a0fs_stage`` (``a0fs_a``  ``_runner_a0fs`` (:1843), stages    ``a0fs_stage_plain``
/ ``a0fs_b``)               "a" and "b"
``fft_axis_ring``           ``_runner_axis0_dma`` (:1324)       ``fft_axis_ring_plain``
(``fft_axis_ring`` /
``fft_axes2_ring``)         and its ``fuse_last`` mode
==========================  ==================================  ======================

The kernels are in ``csrc/fourstep.cu`` (``fft_cols_fs_kernel``: the
twiddle pass and both a0fs stages, instances of ``fft_cols``' register
column body in ``csrc/cols.cuh`` with a store policy of their own) and
``csrc/ring.cu`` (``fft_axis_ring_kernel``, ``fft_axes2_ring_kernel``);
their source notes say how each is bound and built.  The entries the plan
steps call:

* :func:`fft_last_four_step` (step ``stockham4``): ``fft_cols_tw``, then
  ``fft_last`` with the norm scale, then the (b, n1, n2) -> (b, n2, n1)
  swap, which the JAX package also leaves outside its kernels (a torch
  copy here, an XLA ``swapaxes`` there);
* :func:`fft_axis0_fourstep` (``kernel-fourstep-ring``): stage a, stage b;
* :func:`fft_axis_dma` (``kernel-dma-ring``) and :func:`fft_axes2_ring`
  (``kernel-fused2-ring``): one ring pass.

``fft_cols_tw`` takes f32 planes; the four-step last axis takes bf16
planes (complex32) as the JAX package does, through f32 (the cast at both
ends).  The leading-axis four-step and the ring take bf16 planes in their
own kernels (``a0fs_a_bf16``, ``a0fs_b_bf16``, ``fft_axis_ring_bf16``,
``fft_axes2_ring_bf16``): bf16 loads and stores around the f32 tile, which
replace the TPU's 'hd' stage dots and its bf16 slab ring.  As in the JAX
package, a bf16 leading axis whose r1 is below 16 (n = 64, 128) runs the
four-step on f32 planes and returns them f32.

The plain versions compute what the TPU kernels compute in torch ops at full
f32: the four-step twiddle and the stage matrices are float64-generated and
rounded once to f32, as in the JAX package (:func:`_a0fs_tw_mats`,
:func:`_dft_mat` are exact copies).  On bf16 planes they compute in f32 and
round where the TPU kernels round: each stage's output (the ring's bf16
bodies are those of ``fft_cols``/``fft_fused2``).  The four-step CUDA
kernels hold columns in registers and run the butterflies of
``cols_stages`` instead of the dense stage products, writing each output
element once, in the stage's layout, with the twiddle formed from its
exact integer phase (see ``csrc/fourstep.cu``).  The ring
runs ``fft_cols``' register columns (axis mode) and ``fft_fused2``'s
cluster-resident plane (``fuse_last``, the f32 intermediate on chip as
the TPU kernel keeps it in VMEM), both fed by TMA bulk copies with
mbarriers (see ``csrc/ring.cu``): it allocates nothing but the output.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..dtypes import Direction
from . import stockham_kernels as _sk

Pair = _sk.Pair


# ---------------------------------------------------------------------------
# Tables (float64-generated, rounded once to f32)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _dft_mat(r: int, sign: int):
    """Direct (r, r) DFT matrix, split planes.

    Counterpart: ``pallas_stockham.py:1717`` (bit-identical).
    """
    k = np.arange(r)
    th = 2.0 * np.pi * float(sign) * np.outer(k, k) / r
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _a0fs_tw_mats(n: int, sign: int):
    """(r2, r1, r1) stage-a matrices of the leading-axis four-step with the
    twiddle folded in: M_b[k, j] = W_r1[k, j] * W_n^{k*b}.

    Counterpart: ``pallas_stockham.py:1725`` (bit-identical).
    """
    r1, r2 = _sk._a0fs_split(n)
    k = np.arange(r1)
    b = np.arange(r2)
    th = 2.0 * np.pi * float(sign) * (
        np.outer(k, k)[None, :, :] / r1
        + b[:, None, None] * k[None, :, None] / n)
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _four_step_twiddle(n1: int, n2: int, sign: int):
    """(n1, n2) planes of W_N^{k1*j2}, N = n1*n2: the integer phase index
    reduced mod N, the trig in float64, rounded once to f32."""
    big_n = n1 * n2
    e = np.outer(np.arange(n1, dtype=np.int64),
                 np.arange(n2, dtype=np.int64)) % big_n
    th = (2.0 * np.pi * float(sign) / big_n) * e.astype(np.float64)
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _on(device, *planes):
    return [torch.from_numpy(p).to(device) for p in planes]


# ---------------------------------------------------------------------------
# Plain versions (any device, full f32)
# ---------------------------------------------------------------------------
def fft_cols_tw_plain(xr, xi, sign: int) -> Pair:
    """n1-point FFT along the middle axis of (b, n1, n2) planes, times the
    four-step twiddle W_{n1*n2}^{k1*j2}.

    Counterpart: ``pallas_stockham.py:1010`` (``_runner_cols_tw``).
    """
    _, n1, n2 = xr.shape
    ar, ai = _sk.fft_cols_plain(xr, xi, sign)
    tr, ti = _on(xr.device, *_four_step_twiddle(n1, n2, sign))
    return (ar * tr - ai * ti).contiguous(), (ar * ti + ai * tr).contiguous()


def _cmatmul(eq: str, mr, mi, ar, ai) -> Pair:
    """Complex contraction of split planes in four real einsums."""
    return (torch.einsum(eq, mr, ar) - torch.einsum(eq, mi, ai),
            torch.einsum(eq, mr, ai) + torch.einsum(eq, mi, ar))


def _a0fs_launch_name(stage: str, scale: float) -> str:
    """The launch name of an a0fs stage; raises for a stage other than
    "a"/"b" and for a scale on stage a (the scale rides stage b)."""
    if stage not in ("a", "b"):
        raise ValueError(f"stage must be 'a' or 'b', got {stage!r}")
    if stage == "a" and scale != 1.0:
        raise ValueError("stage a takes no scale")
    return "a0fs_" + stage


def a0fs_stage_plain(stage: str, xr, xi, sign: int,
                     scale: float = 1.0) -> Pair:
    """One stage of the leading-axis four-step over (pre, n, post) planes,
    n = r1 * r2 (``_a0fs_split``), as the TPU kernel computes it: dense
    stage matrices, the twiddle folded into stage a's and the norm scale
    into stage b's (float64, then rounded once).

    Stage "a": row k1*r2 + b <- sum_a M_b[k1, a] x[a*r2 + b].
    Stage "b": row k2*r1 + k1 <- sum_b W_r2[k2, b] x[k1*r2 + b] * scale.
    bf16 planes are computed in f32 and the output rounded to bf16.
    Counterpart: ``pallas_stockham.py:1843`` (``_runner_a0fs``).
    """
    _a0fs_launch_name(stage, scale)
    pre, n, post = xr.shape
    r1, r2 = _sk._a0fs_split(n)
    dtype = xr.dtype
    xr, xi = xr.float(), xi.float()
    if stage == "a":
        mr, mi = _on(xr.device, *_a0fs_tw_mats(n, sign))        # (b, k, a)
        yr, yi = _cmatmul("bka,pabc->pkbc", mr, mi,
                          xr.reshape(pre, r1, r2, post),
                          xi.reshape(pre, r1, r2, post))
    else:
        wr, wi = _dft_mat(r2, sign)
        if scale != 1.0:
            wr = (wr.astype(np.float64) * scale).astype(np.float32)
            wi = (wi.astype(np.float64) * scale).astype(np.float32)
        mr, mi = _on(xr.device, wr, wi)                          # (k, b)
        yr, yi = _cmatmul("kb,pjbc->pkjc", mr, mi,
                          xr.reshape(pre, r1, r2, post),
                          xi.reshape(pre, r1, r2, post))
    return (yr.reshape(pre, n, post).to(dtype).contiguous(),
            yi.reshape(pre, n, post).to(dtype).contiguous())


def fft_axis_ring_plain(xr, xi, sign: int, scale: float = 1.0,
                        fuse_last: bool = False) -> Pair:
    """FFT along the middle axis of (pre, n, post) planes, or with
    ``fuse_last`` along both trailing axes of (pre, n1, n2) planes, scale
    applied: the math of ``fft_cols_plain`` / ``fft_fused2_plain``.

    Counterpart: ``pallas_stockham.py:1324`` (``_runner_axis0_dma``).
    """
    if fuse_last:
        return _sk.fft_fused2_plain(xr, xi, sign, scale)
    return _sk.fft_cols_plain(xr, xi, sign, scale)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def fft_cols_tw(xr, xi, sign: int) -> Pair:
    """n1-point FFT along the middle axis of (b, n1, n2) f32 planes times
    W_{n1*n2}^{k1*j2} (n1*n2 a power of two).

    CUDA planes launch ``fft_cols_fs_kernel`` (the stages of
    ``cols_stages``); CPU planes run :func:`fft_cols_tw_plain`.
    Counterpart: ``pallas_stockham.py:1010``.
    """
    if not _sk._on_cuda("fft_cols_tw", xr, xi):
        return fft_cols_tw_plain(xr, xi, sign)
    from . import _build
    b, n1, n2 = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _sk._launch("fft_cols_tw", _build.load().fft_cols_tw, xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                b, n1, n2, sign,
                *_sk._table_args(_sk.cols_keys(n1), sign, xr.device),
                nbytes=4 * xr.nbytes)
    return yr, yi


def a0fs_stage(stage: str, xr, xi, sign: int, scale: float = 1.0) -> Pair:
    """One stage of the leading-axis four-step over (pre, n, post) f32 or
    bf16 planes (see :func:`a0fs_stage_plain`); the scale rides stage b.

    CUDA planes launch ``fft_cols_fs_kernel``'s instance of length r1
    (stage a, with the twiddle) or r2 (stage b), the stages of
    ``cols_stages`` (counted as ``a0fs_a``/``a0fs_b``, with ``_bf16`` for
    their bf16 instances); CPU planes run :func:`a0fs_stage_plain`.
    Counterpart: ``pallas_stockham.py:1843``.
    """
    name = _a0fs_launch_name(stage, scale)
    if not _sk._on_cuda(name, xr, xi, dtypes=_sk.F32_BF16):
        return a0fs_stage_plain(stage, xr, xi, sign, scale)
    pre, n, post = xr.shape
    r1, r2 = _sk._a0fs_split(n)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    scale_arg = () if stage == "a" else (float(scale),)
    keys = [axis0_fourstep_keys(n)[stage == "b"]]
    _sk._launch(*_sk._c2c_entry(name, xr), xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                pre, r1, r2, post, sign, *scale_arg,
                *_sk._table_args(keys, sign, xr.device),
                nbytes=4 * xr.nbytes)
    return yr, yi


def axis_ring_keys(n: int, post: int, fuse_last: bool) -> list:
    """The tables :func:`fft_axis_ring` reads on (pre, n, post) planes."""
    return _sk.walk_keys(n, post) if fuse_last else _sk.cols_keys(n)


def fft_axis_ring(xr, xi, sign: int, scale: float = 1.0,
                  fuse_last: bool = False) -> Pair:
    """FFT along the middle axis of (pre, n, post) f32 or bf16 planes, or
    with ``fuse_last`` along both trailing axes of (pre, n1, n2) planes,
    through a ring of TMA bulk copies, scale fused.

    CUDA planes launch ``fft_axis_ring_kernel`` (counted as
    ``fft_axis_ring``: ``fft_cols``' register columns, the stages of
    ``cols_stages``, tiles and ring depth of ``ring_geometry``) or with
    ``fuse_last`` ``fft_axes2_ring_kernel`` (``fft_axes2_ring``: a
    persistent cluster of ``fused2_cluster`` CTAs a plane, the stages of
    ``fused2_stages``), with ``_bf16`` for their bf16 instances; nothing is
    allocated but the output, and a launch the card refuses (no cluster
    fits, a tensor map it will not encode) raises.  CPU planes run
    :func:`fft_axis_ring_plain`.  Counterpart: ``pallas_stockham.py:1324``.
    """
    name = "fft_axes2_ring" if fuse_last else "fft_axis_ring"
    if not _sk._on_cuda(name, xr, xi, dtypes=_sk.F32_BF16):
        return fft_axis_ring_plain(xr, xi, sign, scale, fuse_last)
    pre, n, post = xr.shape
    per = 16 // xr.element_size()      # elements per 16-byte row
    if post % per or xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError(f"{name}: TMA copies need the last extent a "
                         f"multiple of {per} and 16-byte aligned planes")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    cluster = ((_sk.fused2_cluster(n, post, pre, _sk._sm_count(xr.device)),)
               if fuse_last else ())
    _sk._launch(*_sk._c2c_entry(name, xr), xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                pre, n, post, *cluster, sign, float(scale),
                *_sk._table_args(axis_ring_keys(n, post, fuse_last), sign,
                                 xr.device),
                nbytes=4 * xr.nbytes)
    return yr, yi


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def _pre_post(shape, axis: int):
    pre = int(np.prod(shape[:axis])) if axis else 1
    return pre, int(np.prod(shape[axis + 1:]))


def last_four_step_keys(n: int) -> list:
    """The tables :func:`fft_last_four_step` reads at length n:
    ``fft_cols_tw``'s at n1, then ``fft_last``'s at n2."""
    n1, n2 = _sk._four_step_split(n)
    return _sk.cols_keys(n1) + _sk.last_keys(n2)


def fft_last_four_step(xr, xi, direction: Direction,
                       scale: float = 1.0) -> Pair:
    """FFT along the last axis for power-of-two 4096 <= n <= 2**21.

    Four-step n = n1 * n2 (``_four_step_split``): the column pass over n1
    with the twiddle fused into its write, the last-axis pass over n2 with
    the norm scale, then the swap of the two sub-axes: output index
    k = k1 + n1 * k2.  bf16 planes run through f32: the intermediates stay
    f32 and the output is rounded once to bf16.
    Counterpart: ``pallas_stockham.py:1076``.
    """
    shape = tuple(xr.shape)
    n = shape[-1]
    if not _sk.four_step_supported(n):
        raise ValueError(f"four-step unsupported for n={n}")
    if xr.dtype == torch.bfloat16:
        yr, yi = fft_last_four_step(xr.float(), xi.float(), direction, scale)
        return yr.to(torch.bfloat16), yi.to(torch.bfloat16)
    n1, n2 = _sk._four_step_split(n)
    sign = int(direction)
    b = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    ar, ai = fft_cols_tw(xr.reshape(b, n1, n2), xi.reshape(b, n1, n2), sign)
    br, bi = _sk.fft_last(ar.reshape(b * n1, n2), ai.reshape(b * n1, n2),
                          sign, float(scale))
    # (b, n1, n2) [k1, k2] -> (b, n2, n1): flat index k2 * n1 + k1
    yr = br.reshape(b, n1, n2).transpose(1, 2).reshape(shape)
    yi = bi.reshape(b, n1, n2).transpose(1, 2).reshape(shape)
    return yr, yi


def axis0_fourstep_keys(n: int) -> list:
    """The tables :func:`fft_axis0_fourstep` reads along an axis of n: the
    column body's at r1 (stage a), then at r2 (stage b)."""
    return [k for r in _sk._a0fs_split(n) for k in _sk.cols_keys(r)]


def fft_axis0_fourstep(xr, xi, axis: int, direction: Direction,
                       scale: float = 1.0) -> Pair:
    """FFT along a leading or middle ``axis`` as the two four-step stages
    (:func:`a0fs_stage`); output in natural order, scale on stage b.  bf16
    planes whose r1 is below 16 run on f32 planes and come back f32, as in
    the JAX package (its ``_plane_io(xr, r1)``).

    Counterpart: ``pallas_stockham.py:2020`` (its ring depth ``k`` is a
    VMEM choice with no counterpart here; the DMA ring below takes the
    depth of :func:`~.stockham_kernels.ring_geometry`, not the caller's).
    """
    shape = tuple(xr.shape)
    axis = axis % len(shape)
    n = shape[axis]
    pre, post = _pre_post(shape, axis)
    if not _sk.axis0_fourstep_supported(n, post, shape[-1]):
        raise ValueError(f"axis0-fourstep unsupported for {shape} ax {axis}")
    if xr.dtype == torch.bfloat16 and _sk._a0fs_split(n)[0] < 16:
        xr, xi = xr.float(), xi.float()
    sign = int(direction)
    ar, ai = a0fs_stage("a", xr.reshape(pre, n, post),
                        xi.reshape(pre, n, post), sign)
    yr, yi = a0fs_stage("b", ar, ai, sign, float(scale))
    return yr.reshape(shape), yi.reshape(shape)


def fft_axis_dma(xr, xi, axis: int, direction: Direction,
                 scale: float = 1.0) -> Pair:
    """FFT along a leading or middle ``axis`` in one slab-ring pass.

    Counterpart: ``pallas_stockham.py:1574``.
    """
    shape = tuple(xr.shape)
    axis = axis % len(shape)
    n = shape[axis]
    pre, post = _pre_post(shape, axis)
    if not _sk.axis0_dma_supported(n, post):
        raise ValueError(f"axis-dma unsupported for {shape} axis {axis}")
    yr, yi = fft_axis_ring(xr.reshape(pre, n, post), xi.reshape(pre, n, post),
                           int(direction), float(scale), False)
    return yr.reshape(shape), yi.reshape(shape)


def fft_axes2_ring(xr, xi, direction: Direction,
                   scale: float = 1.0) -> Pair:
    """FFT along the last two axes in one slab-ring pass over whole planes.

    Counterpart: ``pallas_stockham.py:1611``.
    """
    shape = tuple(xr.shape)
    n1, n2 = shape[-2], shape[-1]
    if not _sk.fused2_ring_supported(n1, n2):
        raise ValueError(f"fused2-ring unsupported for {shape}")
    pre = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    yr, yi = fft_axis_ring(xr.reshape(pre, n1, n2), xi.reshape(pre, n1, n2),
                           int(direction), float(scale), True)
    return yr.reshape(shape), yi.reshape(shape)
