"""Guru-layer plans: FFTW's arbitrary-stride problem descriptions over flat
buffers.

Counterpart: ``regent_fft_tpu/guru.py``.  A problem is ``rank`` transform
dimensions plus ``howmany_rank`` loop dimensions, each an ``IODim(n, is,
os)`` of extent and input/output element strides (FFTW's
``api/plan-guru-dft.c``): transposed, interleaved-field and
arbitrary-``dist`` layouts that the axes-based :class:`~.plan.PlanSpec`
cannot express.  A guru plan is gather -> planned FFT -> scatter on the
plan's device; the index tensors are made on the host and uploaded once,
when the plan is made.  Where the strides describe a permuted dense layout
the gather is a reshape and permute (one relayout copy, or none when both
sides are the same view of a C2C plan).  Overlapping output strides are
refused at plan time (undefined in FFTW too); overlapping inputs are legal.

``plan_many`` is ``fftw_plan_many_dft``'s flat (n, howmany, stride, dist)
surface on the guru layer; :class:`GuruR2RPlan` (``plan_guru_r2r``) the
r2r kinds' guru plans, on ``ops/r2r.py``'s plans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .dtypes import (Direction, Kind, Norm, SplitComplex, as_real, as_split,
                     from_split)
from .plan import Plan, PlanSpec, make_plan


@dataclasses.dataclass(frozen=True)
class IODim:
    """One guru dimension: extent and input/output strides in elements of
    the flat buffer (FFTW's ``fftw_iodim``; ``is`` is a Python keyword).

    Counterpart: ``regent_fft_tpu/guru.py:41``.
    """

    n: int
    ins: int   # input stride  (FFTW "is")
    outs: int  # output stride (FFTW "os")


def _as_iodims(dims) -> Tuple[IODim, ...]:
    """IODims from IODims or (n, is, os) tuples.
    Counterpart: ``regent_fft_tpu/guru.py:54``."""
    return tuple(d if isinstance(d, IODim)
                 else IODim(int(d[0]), int(d[1]), int(d[2])) for d in dims)


def _index_map(dims: Sequence[IODim], which: str) -> np.ndarray:
    """Flat element index of every point of ``dims`` (row-major), from the
    input (``"in"``) or output strides.
    Counterpart: ``regent_fft_tpu/guru.py:65``."""
    idx = np.zeros(tuple(d.n for d in dims), dtype=np.int64)
    for axis, d in enumerate(dims):
        stride = d.ins if which == "in" else d.outs
        idx = idx + (np.arange(d.n, dtype=np.int64) * stride).reshape(
            (1,) * axis + (d.n,) + (1,) * (len(dims) - axis - 1))
    return idx


def _dense_permutation(dims: Sequence[IODim], which: str):
    """``(buffer_shape, axes)`` with ``flat[:prod].reshape(buffer_shape)
    .permute(axes)`` the logical array, when the strides are a permutation
    of a dense row-major layout; else None.
    Counterpart: ``regent_fft_tpu/guru.py:76``."""
    strides = [d.ins if which == "in" else d.outs for d in dims]
    if any(s <= 0 for s in strides) or len(set(strides)) != len(strides):
        return None
    order = sorted(range(len(dims)), key=lambda i: -strides[i])
    exp = 1
    for i in reversed(order):
        if strides[i] != exp:
            return None
        exp *= dims[i].n
    buffer_shape = tuple(dims[i].n for i in order)
    axes = tuple(order.index(j) for j in range(len(dims)))
    return buffer_shape, axes


def _check_layout(idx: np.ndarray, what: str, require_unique: bool) -> int:
    """The layout's span; negative and (for outputs) overlapping indices
    raise.  Counterpart: ``regent_fft_tpu/guru.py:101``."""
    if idx.size and idx.min() < 0:
        raise ValueError(f"{what} layout reaches a negative index "
                         f"({idx.min()}); strides/extents are inconsistent")
    if require_unique and idx.size != np.unique(idx).size:
        raise ValueError(f"{what} layout has overlapping elements "
                         "(undefined in FFTW's guru API as well)")
    return int(idx.max()) + 1 if idx.size else 0


def _gatherer(fast, idx: np.ndarray, device):
    """flat -> the logical array of ``idx``'s layout, contiguous: a reshape
    and permute of a permuted dense layout (``fast``), else an index
    gather with the indices uploaded to ``device`` once."""
    if fast is not None:
        bshape, baxes = fast
        span = int(np.prod(bshape))
        return (lambda flat: flat[:span].reshape(bshape).permute(baxes)
                .contiguous())
    gi = torch.from_numpy(idx.ravel()).to(device)
    return lambda flat: flat.index_select(0, gi).reshape(idx.shape)


def _scatterer(fast, idx: np.ndarray, size: int, device):
    """The logical array -> a flat buffer of ``size``, zero outside the
    layout: the inverse permute of a permuted dense layout, else an index
    scatter with the indices uploaded to ``device`` once."""
    if fast is not None:
        inv = tuple(int(v) for v in np.argsort(fast[1]))
        return lambda y: y.permute(inv).reshape(-1)
    so = torch.from_numpy(idx.ravel()).to(device)
    return lambda y: y.new_zeros(size).index_copy_(0, so, y.reshape(-1))


class GuruPlan:
    """An executable guru plan (C2C, R2C or C2R) over flat buffers.

    Call with a flat complex array or tensor (or :class:`SplitComplex`
    planes; a flat real one for R2C) at least as long as the input layout's
    span; returns a flat result of length ``out_size``, zero outside the
    output layout, on the plan's device.  Keyword options go to the inner
    :class:`PlanSpec` (``device``, ``backend``, ...).
    Counterpart: ``regent_fft_tpu/guru.py:111``.
    """

    def __init__(self, dims, howmany_dims=(), kind: Kind = Kind.C2C,
                 direction: Direction = Direction.FORWARD,
                 norm: Norm = Norm.NONE, dtype: str = "complex64",
                 out_size: Optional[int] = None, **plan_opts):
        self.dims = _as_iodims(dims)
        self.howmany_dims = _as_iodims(howmany_dims)
        self.kind = kind = Kind(kind)
        if not self.dims:
            raise ValueError("at least one transform dimension required")
        # the inner dense plan: loop dims lead, transform dims trail
        shape = tuple(d.n for d in self.howmany_dims + self.dims)
        axes = tuple(range(len(self.howmany_dims), len(shape)))
        last = self.dims[-1]
        half = (IODim(last.n // 2 + 1, last.ins, last.outs),)
        in_dims = self.howmany_dims + self.dims
        out_dims = in_dims
        if kind == Kind.C2R:      # the complex input's last dim is n//2+1
            in_dims = self.howmany_dims + self.dims[:-1] + half
        if kind == Kind.R2C:
            out_dims = self.howmany_dims + self.dims[:-1] + half
        idx_in = _index_map(in_dims, "in")
        idx_out = _index_map(out_dims, "out")
        self.in_size = _check_layout(idx_in, "input", require_unique=False)
        min_out = _check_layout(idx_out, "output", require_unique=True)
        self.out_size = out_size if out_size is not None else min_out
        if self.out_size < min_out:
            raise ValueError(f"out_size {self.out_size} < layout span "
                             f"{min_out}")
        # permuted dense layouts: on both sides of a C2C plan the inner plan
        # runs on the buffer's own layout (no copy); on one side a reshape
        # and permute (one relayout copy); otherwise gather and scatter
        in_fast = _dense_permutation(in_dims, "in")
        out_fast = (_dense_permutation(out_dims, "out")
                    if self.out_size == idx_out.size else None)
        self.in_is_transpose_view = in_fast is not None
        self.out_is_transpose_view = out_fast is not None
        self.is_zero_copy = (kind == Kind.C2C and in_fast is not None
                             and in_fast == out_fast)
        if self.is_zero_copy:
            shape, baxes = in_fast
            axes = tuple(sorted(baxes[j] for j in axes))
        self.spec = PlanSpec(shape=shape, axes=axes, kind=kind,
                             direction=direction, norm=norm, dtype=dtype,
                             **plan_opts)
        self._plan: Plan = make_plan(self.spec)
        dev = self._plan.device

        if self.is_zero_copy:
            span = int(np.prod(shape))
            self._gather = lambda flat: flat[:span].reshape(shape)
            self._scatter = lambda y: y.reshape(-1)
        else:
            self._gather = _gatherer(in_fast, idx_in, dev)
            self._scatter = _scatterer(out_fast, idx_out, self.out_size, dev)
        self._destroyed = False

    def _check_flat(self, flat):
        if flat.ndim != 1:
            raise ValueError(f"guru plans take FLAT buffers; got shape "
                             f"{tuple(flat.shape)}")
        if flat.shape[0] < self.in_size:
            raise ValueError(f"input buffer length {flat.shape[0]} < "
                             f"layout span {self.in_size}")

    def __call__(self, x):
        """Counterpart: ``regent_fft_tpu/guru.py:251``."""
        if self._destroyed:
            raise RuntimeError("plan was destroyed (destroy_plan); "
                               "re-plan first")
        p, g, s = self._plan, self._gather, self._scatter
        dt = self.spec.dtype
        if self.kind == Kind.R2C:
            x = as_real(x, p.device, p.cdtype)
            self._check_flat(x)
            yr, yi = p.execute_real(g(x))
            return from_split(SplitComplex(s(yr), s(yi)), dt)
        sx = as_split(x, p.device, p.cdtype)
        self._check_flat(sx.re)
        if self.kind == Kind.C2R:
            y = s(p.execute_split(g(sx.re), g(sx.im)))
            return y.to(torch.bfloat16) if dt == "complex32" else y
        yr, yi = p.execute_split(g(sx.re), g(sx.im))
        return from_split(SplitComplex(s(yr), s(yi)), dt)

    execute = __call__

    def describe(self) -> str:
        """Counterpart: ``regent_fft_tpu/guru.py:272``."""
        dims = " ".join(f"(n={d.n} is={d.ins} os={d.outs})" for d in self.dims)
        hm = " ".join(f"(n={d.n} is={d.ins} os={d.outs})"
                      for d in self.howmany_dims)
        return (f"(guru-{self.kind.value} dims=[{dims}] howmany=[{hm}] "
                f"in_size={self.in_size} out_size={self.out_size})\n"
                + self._plan.describe())


def plan_guru(dims, howmany_dims=(), kind: Kind = Kind.C2C,
              direction: Direction = Direction.FORWARD,
              norm: Norm = Norm.NONE, dtype: str = "complex64",
              out_size: Optional[int] = None, **plan_opts) -> GuruPlan:
    """``fftw_plan_guru_dft`` analog: ``dims``/``howmany_dims`` are IODims or
    (n, is, os) tuples over the flat buffers.
    Counterpart: ``regent_fft_tpu/guru.py:281``."""
    return GuruPlan(dims, howmany_dims, kind=kind, direction=direction,
                    norm=norm, dtype=dtype, out_size=out_size, **plan_opts)


class GuruR2RPlan:
    """Guru-layout real-to-real plan (``fftw_plan_guru_r2r`` analog,
    ``fftw-3.3.8/api/plan-guru-r2r.c``): one r2r kind per transform
    dimension, arbitrary element strides over flat real buffers.

    r2r transforms keep extents, so the input and output layouts are both
    ``howmany_dims + dims``.  The gather and scatter are index ops whose
    index tensors go to the plan's device once, when the plan is made; the
    input is cast to float32, as in the JAX package.  Unnormalized FFTW
    semantics, like :class:`~.ops.r2r.R2RPlan`.
    Counterpart: ``regent_fft_tpu/guru.py:294``.
    """

    def __init__(self, dims, kinds, howmany_dims=(), dtype: str = "float32",
                 out_size: Optional[int] = None, max_radix: int = 128,
                 precision: str = "highest", device="cuda"):
        from .ops.r2r import R2RKind, plan_r2r
        self.dims = _as_iodims(dims)
        self.howmany_dims = _as_iodims(howmany_dims)
        if not self.dims:
            raise ValueError("at least one transform dimension required")
        if isinstance(kinds, int) or not isinstance(kinds, Sequence):
            kinds = (kinds,) * len(self.dims)
        self.kinds = tuple(R2RKind(k) for k in kinds)
        if len(self.kinds) != len(self.dims):
            raise ValueError(f"{len(self.kinds)} kinds for "
                             f"{len(self.dims)} dims")
        shape = tuple(d.n for d in self.howmany_dims + self.dims)
        axes = tuple(range(len(self.howmany_dims), len(shape)))
        self._plan = plan_r2r(shape, self.kinds, axes=axes,
                              max_radix=max_radix, precision=precision,
                              device=device)
        all_dims = self.howmany_dims + self.dims
        idx_in = _index_map(all_dims, "in")
        idx_out = _index_map(all_dims, "out")
        self.in_size = _check_layout(idx_in, "input", require_unique=False)
        min_out = _check_layout(idx_out, "output", require_unique=True)
        self.out_size = out_size if out_size is not None else min_out
        if self.out_size < min_out:
            raise ValueError(f"out_size {self.out_size} < layout span "
                             f"{min_out}")
        dev = self._plan.device
        self._gather = _gatherer(None, idx_in, dev)
        self._scatter = _scatterer(None, idx_out, self.out_size, dev)
        self._destroyed = False

    def __call__(self, x):
        """Counterpart: ``regent_fft_tpu/guru.py:350``."""
        if self._destroyed:
            raise RuntimeError("plan was destroyed (destroy_plan); "
                               "re-plan first")
        from .ops.r2r import _as_tensor
        x = _as_tensor(x)
        if x.ndim != 1:
            raise ValueError(f"guru plans take FLAT buffers; got shape "
                             f"{tuple(x.shape)}")
        if x.shape[0] < self.in_size:
            raise ValueError(f"input buffer length {x.shape[0]} < "
                             f"layout span {self.in_size}")
        x = x.to(device=self._plan.device, dtype=torch.float32)
        return self._scatter(self._plan._core(self._gather(x)))

    execute = __call__

    def describe(self) -> str:
        """Counterpart: ``regent_fft_tpu/guru.py:361``."""
        dims = " ".join(f"(n={d.n} is={d.ins} os={d.outs})" for d in self.dims)
        hm = " ".join(f"(n={d.n} is={d.ins} os={d.outs})"
                      for d in self.howmany_dims)
        kinds = ",".join(k.name for k in self.kinds)
        return (f"(guru-r2r kinds=[{kinds}] dims=[{dims}] howmany=[{hm}] "
                f"in_size={self.in_size} out_size={self.out_size})\n"
                + self._plan.description)


def plan_guru_r2r(dims, kinds, howmany_dims=(), **opts) -> GuruR2RPlan:
    """``fftw_plan_guru_r2r`` analog over flat real buffers: ``dims``/
    ``howmany_dims`` are IODims or (n, is, os) tuples, ``kinds`` one
    :class:`~.ops.r2r.R2RKind` per transform dim (or one for all).
    Counterpart: ``regent_fft_tpu/guru.py:370``."""
    return GuruR2RPlan(dims, kinds, howmany_dims, **opts)


def plan_many(n: Sequence[int], howmany: int = 1, *,
              istride: int = 1, idist: Optional[int] = None,
              ostride: int = 1, odist: Optional[int] = None,
              kind: Kind = Kind.C2C,
              direction: Direction = Direction.FORWARD,
              norm: Norm = Norm.NONE, dtype: str = "complex64",
              **plan_opts) -> GuruPlan:
    """``fftw_plan_many_dft`` analog: ``howmany`` row-major transforms of
    extents ``n``, ``idist``/``odist`` elements apart, innermost elements
    ``istride``/``ostride`` apart (FFTW's contiguous defaults: dist =
    prod(n), stride 1).  Counterpart: ``regent_fft_tpu/guru.py:379``."""
    kind = Kind(kind)
    n = [int(v) for v in n]
    logical = int(np.prod(n))
    out_last = n[-1] // 2 + 1 if kind == Kind.R2C else n[-1]
    in_last = n[-1] // 2 + 1 if kind == Kind.C2R else n[-1]
    if idist is None:
        idist = logical // n[-1] * in_last * istride
    if odist is None:
        odist = logical // n[-1] * out_last * ostride
    dims = []
    is_acc, os_acc = istride, ostride
    for i in range(len(n) - 1, -1, -1):
        dims.append(IODim(n[i], is_acc, os_acc))
        is_acc *= in_last if i == len(n) - 1 else n[i]
        os_acc *= out_last if i == len(n) - 1 else n[i]
    dims.reverse()
    hm = (IODim(howmany, idist, odist),) if howmany > 1 else ()
    return GuruPlan(dims, hm, kind=kind, direction=direction, norm=norm,
                    dtype=dtype, **plan_opts)
