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
and ``_chunked_call`` (:52-125) are VMEM and Mosaic limits: here
:func:`mm_geometry` picks the rows a tile, the kernels mask the ragged
batch edge instead of padding it and take any batch in one launch, so the
port leaves them out.

The JAX kernels run their products at the plan's precision (HIGHEST,
HIGH or DEFAULT); both kernels here run them on the H100's tensor cores
in a 3xTF32 split at every precision (each f32 operand a split once into
hi = tf32(a) and lo = tf32(a - hi), every real product lo*hi' + hi*lo' +
hi*hi' accumulated in f32; never plain TF32), which keeps f32-grade
error: ~2^-22 a product; on an H100 rel_l2 at most 2.6e-7 against
float64 and 3.9e-7 against the plain versions over every admitted length
(chip_smoke's sweeps; :func:`mm_geometry` is the launch the CPU
emulation in ``tests/test_torch_port_pallas_fft.py`` follows).
Their DFT matrices and twiddle come from tables of the n-th roots of
unity generated in float64 and rounded once to f32
(``twiddle._exp_table``), indexed by the exponent reduced mod n, so they
hold the JAX tables' values bit for bit.  The plain versions are the JAX
bodies in torch ops at full f32 (``torch.matmul``; callers on the card
keep ``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's
default).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

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
# Launch geometry (csrc/matmul.cu checks it again)
# ---------------------------------------------------------------------------
MM_THREADS = 256           # 8 warps a CTA, one warp unit each a round
MM_WARPS = MM_THREADS // 32
MM_UNIT_TILES = 6          # 16 x 8 accumulator tiles a warp unit
MM_TILE_ELEMS = 8192       # target complex elements a row tile
SMEM_PER_CTA = _sk.SMEM_PER_CTA


class MMGeometry(NamedTuple):
    rows: int        # R, rows a tile
    buffers: int     # 2: tile t+1 loads while tile t computes; 1: no room
    smem: int        # dynamic shared memory bytes a CTA
    ctas: int        # persistent CTAs (grid)
    threads: int
    direct: bool     # the last stage takes rounds and stores from registers


def mm_pitch(n2: int) -> int:
    """Floats between rows nu1 (and k1) of a tile row: ceil8(n2) + 4, so
    the B fragments of the second stage hit 32 distinct banks."""
    return -(-n2 // 8) * 8 + 4


def mm_smem(n1: int, n2: int, rows: int, buffers: int) -> int:
    """Shared memory of one CTA: ``buffers`` tiles of ``rows`` regions of
    n1 * mm_pitch(n2) floats, re and im, then the n1 + n2 roots."""
    return 4 * (buffers * 2 * rows * n1 * mm_pitch(n2) + 2 * (n1 + n2))


def mm_halves(length: int) -> bool:
    """Does a stage take the radix-2 step (W_L^{(j + L/2) k} = (-1)^k
    W_L^{jk}) and contract its sums (outputs 2m) and differences (2m + 1)
    over L/2?  Where L is even and the two half contractions take fewer
    (16-row m-tile, 8-deep K step) pairs than the whole one."""
    h = length // 2
    return (length % 2 == 0 and 2 * -(-h // 16) * -(-h // 8)
            < -(-length // 16) * -(-length // 8))


def mm_depth(length: int) -> Tuple[int, int]:
    """(H, parities) of a stage: (length / 2, 2) where :func:`mm_halves`,
    else (length, 1)."""
    return (length // 2, 2) if mm_halves(length) else (length, 1)


def mm_unit(depth: int) -> Tuple[int, int]:
    """(MT, NT) of a warp unit: MT 16-row m-tiles by NT 8-column n-tiles,
    ``MM_UNIT_TILES`` accumulator tiles either way (2 x 3 past a depth of
    16, else 1 x 6)."""
    return ((2, MM_UNIT_TILES // 2) if depth > 16
            else (1, MM_UNIT_TILES))


def mm_group(length: int) -> int:
    """Warp units of one column group of a stage (its parities' m-groups of
    16 MT outputs): a round of the stage takes whole groups, so at most
    ``MM_WARPS``."""
    h, np_ = mm_depth(length)
    return np_ * -(-h // (16 * mm_unit(h)[0]))


def mm_units(length: int, ncols: int) -> int:
    """Warp units of a stage of ``length`` outputs over ``ncols`` columns:
    column groups of 8 NT columns, :func:`mm_group` units each."""
    nt = mm_unit(mm_depth(length)[0])[1]
    return mm_group(length) * -(-ncols // (8 * nt))


def mm_geometry(n1: int, n2: int, batch: int, sms: int = 132) -> MMGeometry:
    """Launch of ``fft_mm1`` (n1 = 1, n2 = n) or ``fft_mm2`` on ``batch``
    rows over a card of ``sms`` SMs: R = ``MM_TILE_ELEMS`` // n rows a tile
    (at least 1), fewer while a stage has more warp units than the CTA's
    warps or two buffers of R rows exceed ``SMEM_PER_CTA``; two buffers
    where they fit, else one; CTAs: one an SM (the kernel takes over 128
    registers a thread, so no second CTA of 256 threads fits), no more than
    there are tiles."""
    n = n1 * n2
    if max(mm_group(n1), mm_group(n2)) > MM_WARPS:
        raise ValueError(f"fft_mm: a column group of ({n1}, {n2}) needs "
                         f"more than {MM_WARPS} warps")

    def units(r):
        u = mm_units(n2, r * n1)
        return max(u, mm_units(n1, r * n2)) if n1 > 1 else u
    rows = max(1, MM_TILE_ELEMS // n)
    while rows > 1 and (units(rows) > MM_WARPS
                        or mm_smem(n1, n2, rows, 2) > SMEM_PER_CTA):
        rows -= 1
    buffers = 2 if mm_smem(n1, n2, rows, 2) <= SMEM_PER_CTA else 1
    smem = mm_smem(n1, n2, rows, buffers)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"fft_mm: no tile fits for ({n1}, {n2})")
    tiles = -(-batch // rows)
    return MMGeometry(rows, buffers, smem, max(1, min(tiles, sms)),
                      MM_THREADS, mm_units(n2, rows * n1) > MM_WARPS)


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

    CUDA planes launch ``fft_mm_kernel<false>`` (3xTF32 tensor-core
    products, :func:`mm_geometry` with n1 = 1); CPU planes run
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
    geo = mm_geometry(1, n, b, _sk._sm_count(xr.device))
    _sk._launch("fft_mm1", _build.load().fft_mm1, xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                b, n, geo.rows, geo.buffers, geo.ctas, geo.smem,
                roots.data_ptr(), nbytes=4 * xr.nbytes)
    return yr, yi


def fft_mm2(xr, xi, n1: int, n2: int, sign: int) -> Pair:
    """Two-stage four-step of (B, n1*n2) f32 rows, 2 <= n_i <= 128; output
    index k1 + n1*k2.

    CUDA planes launch ``fft_mm_kernel<true>`` (3xTF32 tensor-core
    products, both stages and the twiddle on chip, :func:`mm_geometry`);
    CPU planes run :func:`fft_mm2_plain`.  Counterpart: ``pallas_fft.py:157``.
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
    geo = mm_geometry(n1, n2, b, _sk._sm_count(xr.device))
    _sk._launch("fft_mm2", _build.load().fft_mm2, xr.device,
                xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                b, n1, n2, geo.rows, geo.buffers, geo.ctas, geo.smem,
                tables.data_ptr(), nbytes=4 * xr.nbytes)
    return yr, yi


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def build_c2c_1d_pallas(n: int, direction: Direction):
    """fn((B, n) re, im) -> (re, im) on the matmul-form kernels, or None
    where ``_plan_kind`` finds no schedule (the caller takes the dense
    pipeline).  The JAX function's ``max_radix``, ``precision``,
    ``use_3m`` and ``planner`` change nothing here (``_plan_kind`` ignores
    the first, and the kernels run the 3xTF32 split at every precision),
    so the port leaves them out.  Counterpart: ``pallas_fft.py:210``.
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
