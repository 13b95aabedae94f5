"""Matmul-form DFT kernels: the ``backend="pallas"`` 1-D pipeline.

Counterpart: ``regent_fft_tpu/ops/pallas_fft.py``.  Its two TPU kernels
become two hand-written CUDA entry points in ``csrc/matmul.cu``, each
counted in ``stockham_kernels.LAUNCHES``:

========================  ================================  ==================
wrapper (launch name)     replaces (pallas_fft.py)          plain version
========================  ================================  ==================
``fft_mm1``               ``_runner_1stage`` (:129)         ``fft_mm1_plain``
``fft_mm2``               ``_runner_2stage`` (:157)         ``fft_mm2_plain``
========================  ================================  ==================

``fft_mm1`` is the direct DFT of (B, n) rows, n <= 128: y = x . D_n.
``fft_mm2`` is the fused two-stage four-step of (B, n) rows, n = n1 * n2
with 16 <= n_i <= 128 (``two_stage_split``): the row viewed as (n1, n2),
D_{n1} contracted over nu1, the twiddle W_n^{nu2*k1}, D_{n2} contracted
over nu2, output index k1 + n1*k2.

:func:`build_c2c_1d_pallas` picks one of them by ``_plan_kind`` (the JAX
package's choice) and returns None only where the JAX one does for want of
a schedule; the plan then takes the dense pipeline of ``ops/stockham.py``.
The JAX function also returns None off the TPU; the port's returned
function runs on either device: CUDA planes launch the kernels, CPU planes
run the plain versions.  The JAX ``pick_tile_batch``, ``MAX_CALL_ELEMS``
and ``_chunked_call`` (:52-125) are VMEM and Mosaic limits: the kernels
choose their own rows per block, mask the ragged batch edge instead of
padding it, and take any batch in one launch, so the port leaves them out.

The JAX kernels run their products at the plan's precision (HIGHEST,
HIGH or DEFAULT); both kernels here compute exact f32 at every precision
(FFMA, no TF32), which is at least as accurate.  Their DFT matrices and
twiddle come from tables of the n-th roots of unity generated in float64
and rounded once to f32 (``twiddle._exp_table``), indexed by the exponent
reduced mod n, so they hold the JAX tables' values bit for bit.  The plain
versions are the JAX bodies in torch ops at full f32 (``torch.matmul``;
callers on the card keep ``torch.backends.cuda.matmul.allow_tf32`` False,
PyTorch's default).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..dtypes import Direction
from . import factor as _factor
from . import stockham_kernels as _sk
from . import twiddle as _twiddle

Pair = _sk.Pair


def two_stage_split(n: int) -> Optional[Tuple[int, int]]:
    """n = n1*n2 with 16 <= n_i <= 128, n1 >= n2, or None.

    Counterpart: ``regent_fft_tpu/ops/pallas_fft.py:103``.
    """
    s = _factor.pallas_schedule(n)
    if s is None or len(s) != 2:
        return None
    return (s[0], s[1])


def _plan_kind(n: int):
    """("direct",) for 2 <= n <= 128, ("two", (n1, n2)) where
    ``two_stage_split`` holds, else None.  Like the JAX one it ignores the
    plan's ``max_radix``.  Counterpart: ``pallas_fft.py:201``."""
    if 2 <= n <= 128:
        return ("direct",)
    split = two_stage_split(n)
    if split is not None:
        return ("two", split)
    return None


# ---------------------------------------------------------------------------
# Plain versions (any device, full f32)
# ---------------------------------------------------------------------------
def _dft_mat(n: int, sign: int, device) -> Pair:
    return tuple(torch.from_numpy(t).to(device)
                 for t in _twiddle.dft_matrix(n, sign))


def _cdot_mid(xr, xi, dr, di) -> Pair:
    """Contract axis 1 of (b, n, t) planes with the (n, k) matrix ->
    (b, t, k).  Counterpart: ``pallas_fft.py:90``."""
    def d(v, m):
        return torch.matmul(v.transpose(1, 2), m)
    return d(xr, dr) - d(xi, di), d(xr, di) + d(xi, dr)


def fft_mm1_plain(xr, xi, n: int, sign: int) -> Pair:
    """Direct DFT of (B, n) f32 rows: the four real products of
    ``_cdot_last`` on ``dft_matrix(n, sign)``.

    Counterpart: ``pallas_fft.py:129`` (``_runner_1stage``).
    """
    dr, di = _dft_mat(n, sign, xr.device)
    return ((xr @ dr - xi @ di).contiguous(),
            (xr @ di + xi @ dr).contiguous())


def fft_mm2_plain(xr, xi, n1: int, n2: int, sign: int) -> Pair:
    """Two-stage four-step of (B, n1*n2) f32 rows: ``_cdot_mid`` with
    D_{n1}, the twiddle T[nu2, k1], ``_cdot_mid`` with D_{n2}, then the
    swap to output index k1 + n1*k2.

    Counterpart: ``pallas_fft.py:157`` (``_runner_2stage``).
    """
    b = xr.shape[0]
    n = n1 * n2
    d1r, d1i = _dft_mat(n1, sign, xr.device)
    d2r, d2i = _dft_mat(n2, sign, xr.device)
    twr, twi = (torch.from_numpy(np.ascontiguousarray(t.T)).to(xr.device)
                for t in _twiddle.twiddle_outer(n1, n2, n, sign))  # (nu2, k1)
    ar, ai = _cdot_mid(xr.reshape(b, n1, n2), xi.reshape(b, n1, n2),
                       d1r, d1i)                                 # (b, n2, k1)
    ar, ai = ar * twr - ai * twi, ar * twi + ai * twr
    cr, ci = _cdot_mid(ar, ai, d2r, d2i)                         # (b, k1, k2)
    return (cr.transpose(1, 2).reshape(b, n).contiguous(),
            ci.transpose(1, 2).reshape(b, n).contiguous())


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def _device_roots(lengths: Tuple[int, ...], sign: int,
                  device: torch.device) -> torch.Tensor:
    """The kernels' table on ``device``: for each length m in ``lengths``,
    the m roots exp(sign*2*pi*i*e/m), e = 0..m-1, as (re, im) f32 pairs,
    one length after the other."""
    parts = [np.stack(_twiddle._exp_table(np.arange(m), m, sign, np.float32),
                      -1) for m in lengths]
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts))
                            ).to(device)


def fft_mm1(xr, xi, n: int, sign: int) -> Pair:
    """Direct DFT of (B, n) f32 rows, 1 <= n <= 128.

    CUDA planes launch ``fft_mm1_kernel``; CPU planes run
    :func:`fft_mm1_plain`.  Counterpart: ``pallas_fft.py:129``.
    """
    if not _sk._on_cuda("fft_mm1", xr, xi):
        return fft_mm1_plain(xr, xi, n, sign)
    from . import _build
    b = xr.shape[0]
    if xr.shape != (b, n) or not 1 <= n <= 128:
        raise ValueError(f"fft_mm1: planes {tuple(xr.shape)} for n={n}; the "
                         "kernel takes (B, n) rows with 1 <= n <= 128")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    roots = _device_roots((n,), sign, xr.device)
    _sk._launch("fft_mm1", _build.load().fft_mm1, xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                b, n, roots.data_ptr())
    return yr, yi


def fft_mm2(xr, xi, n1: int, n2: int, sign: int) -> Pair:
    """Two-stage four-step of (B, n1*n2) f32 rows, 2 <= n_i <= 128; output
    index k1 + n1*k2.

    CUDA planes launch ``fft_mm2_kernel``; CPU planes run
    :func:`fft_mm2_plain`.  Counterpart: ``pallas_fft.py:157``.
    """
    if not _sk._on_cuda("fft_mm2", xr, xi):
        return fft_mm2_plain(xr, xi, n1, n2, sign)
    from . import _build
    b = xr.shape[0]
    n = n1 * n2
    if xr.shape != (b, n) or not (2 <= n1 <= 128 and 2 <= n2 <= 128):
        raise ValueError(f"fft_mm2: planes {tuple(xr.shape)} for "
                         f"{(n1, n2)}; the kernel takes (B, n1*n2) rows "
                         "with 2 <= n_i <= 128")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tables = _device_roots((n1, n2, n), sign, xr.device)
    _sk._launch("fft_mm2", _build.load().fft_mm2, xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                b, n1, n2, tables.data_ptr())
    return yr, yi


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def build_c2c_1d_pallas(n: int, direction: Direction):
    """fn((B, n) re, im) -> (re, im) on the matmul-form kernels, or None
    where ``_plan_kind`` finds no schedule (the caller takes the dense
    pipeline).  The JAX function's ``max_radix``, ``precision``,
    ``use_3m`` and ``planner`` change nothing here (``_plan_kind`` ignores
    the first, and the kernels compute exact f32), so the port leaves them
    out.  Counterpart: ``pallas_fft.py:210``.
    """
    kind = _plan_kind(n)
    if kind is None:
        return None
    sign = int(direction)
    if kind[0] == "direct":
        def fn(xr, xi):
            return fft_mm1(xr.contiguous(), xi.contiguous(), n, sign)
        return fn
    n1, n2 = kind[1]

    def fn(xr, xi):
        return fft_mm2(xr.contiguous(), xi.contiguous(), n1, n2, sign)
    return fn
