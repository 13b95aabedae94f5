"""Distributed real-to-real transforms: FFTW's MPI r2r layer.

Counterpart: ``regent_fft_tpu/parallel/distributed_r2r.py``.
``fftw_mpi_plan_r2r`` (``mpi/api.c:687-731``, solver ``mpi/rdft-rank-geq2.c``)
plans an N-D r2r transform, one FFTW kind per axis, with the first axis
block-distributed.  The plan is the slab C2C pipeline
(``distributed.make_plan_slab``) on one real plane: r2r over the local axes
1..nd-1 (``ops/r2r.build_r2r_1d``, so f32 at a core length ``fft_last``
takes runs that kernel on the card), one exchange trading axis 0 for the
last axis, r2r of axis 0, and the exchange back unless ``transposed_out``
(FFTW_MPI_TRANSPOSED_OUT: the result stays split over the last axis).
Every exchange moves one real plane, half the bytes of a C2C plan of the
same shape.  Built collectively, like every distributed plan: each rank
passes its local block and gets its local block back.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dtypes import as_real
from ..ops import factor as _factor
from ..ops import r2r as _r2r
from .distributed import (DistributedFFTPlan, _exchange_start, _layout,
                          _mesh_axis, _setup)
from .mesh import make_fft_mesh


def _r2r_axes_core(local_shape, axes, kinds, max_radix, device):
    """fn(real block) -> real block: the unnormalized r2r of each axis in
    turn, rows of the axis moved last.  Counterpart:
    ``distributed_r2r.py:40``."""
    fns = [(a, _r2r.build_r2r_1d(int(local_shape[a]), k, max_radix,
                                 device=device, dtype=torch.float32))
           for a, k in zip(axes, kinds)]

    def core(x):
        for a, fn in fns:
            moved = x.movedim(a, -1)
            y = fn(moved.reshape(-1, moved.shape[-1]))
            x = y.reshape(moved.shape[:-1] + (y.shape[-1],)).movedim(-1, a)
        return x
    return core


class DistributedR2RPlan(DistributedFFTPlan):
    """A slab-distributed N-D r2r plan: the calling rank's real local
    block in (f32), its real block out.  ``in_block``/``out_block``,
    ``in_spec``/``out_spec`` and the local shapes are those of
    :class:`~.distributed.DistributedFFTPlan`.
    Counterpart: ``distributed_r2r.py:61``."""

    def plane_dtype(self):
        return torch.float32

    def execute_real(self, x: torch.Tensor):
        """The local real plane (``local_in_shape``, f32, on the plan's
        device) -> the local output plane."""
        self._check()
        return self._out.crop(self._fn(x), self.local_out_shape)

    def execute_split(self, xr, xi):
        raise TypeError("an r2r plan takes one real plane: execute_real")

    def __call__(self, x):
        self._check()
        try:
            x = as_real(x, self.device, torch.float32)
        except TypeError:
            raise TypeError("r2r plans take real input") from None
        if tuple(x.shape) != self.local_in_shape:
            raise ValueError(f"local input shape {tuple(x.shape)} != planned "
                             f"{self.local_in_shape}")
        return self.execute_real(x)

    execute = __call__

    def __repr__(self):
        return f"DistributedR2RPlan{self.description}"


def make_plan_slab_r2r(shape, kinds, mesh=None, axis_name: str = "fft",
                       transposed_out: bool = False,
                       max_radix: int = _factor.DEFAULT_MAX_RADIX,
                       precision: str = "highest",
                       device="cuda") -> DistributedR2RPlan:
    """Global N-D r2r transform, slab-decomposed over the first axis.

    ``kinds``: one :class:`~regent_fft_tpu_torch.ops.r2r.R2RKind` for every
    axis or one per axis, in FFTW's argument order.  Unnormalized FFTW
    semantics.  Needs rank >= 2 and the world size dividing axes 0 and -1
    (the exchange trades them); ``transposed_out`` keeps the result split
    over the last axis and skips the second exchange.  The plans compute
    in f32 as "highest" whatever ``precision``, as every port plan does.
    Counterpart: ``distributed_r2r.py:97``."""
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    ax = _mesh_axis(mesh, name)
    p = ax.size
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    if nd < 2:
        raise ValueError("slab r2r needs rank >= 2 (use ops.r2r.plan_r2r "
                         "for single-device 1-D transforms)")
    if isinstance(kinds, (int, _r2r.R2RKind)):
        kinds = (_r2r.R2RKind(kinds),) * nd
    kinds = tuple(_r2r.R2RKind(k) for k in kinds)
    if len(kinds) != nd:
        raise ValueError(f"{len(kinds)} kinds for rank-{nd} transform")
    if shape[0] % p or shape[-1] % p:
        raise ValueError(
            f"axes 0 and -1 must be divisible by mesh size {p}: {shape}")
    core_local = _r2r_axes_core((shape[0] // p,) + shape[1:], range(1, nd),
                                kinds[1:], max_radix, dev)
    core_ax0 = _r2r_axes_core(shape[:-1] + (shape[-1] // p,), (0,),
                              kinds[:1], max_radix, dev)

    def local_fn(x):
        x = _exchange_start([core_local(x)], ax, nd - 1, 0).wait()[0]
        x = core_ax0(x)
        if not transposed_out:
            x = _exchange_start([x], ax, 0, nd - 1).wait()[0]
        return x

    slab_l = _layout(shape, {0: (name, shape[0] // p)})
    out_l = (_layout(shape, {nd - 1: (name, shape[-1] // p)})
             if transposed_out else slab_l)
    flops = 0.0
    for a, k in zip(range(nd), kinds):
        nl = _r2r.logical_size(shape[a], k)
        flops += (2.5 * np.prod(shape) / shape[a]
                  * nl * max(1.0, math.log2(max(nl, 2))))
    kind_names = ",".join(k.name for k in kinds)
    desc = (f"(plan-distrib-slab-r2r shape={shape} P={p} "
            f"kinds=[{kind_names}] local-r2r(axes 1..{nd-1}) -> "
            f"all_to_all(real) -> r2r(axis0)"
            f"{' [transposed output]' if transposed_out else ' -> a2a back'})")
    return DistributedR2RPlan(desc, mesh, dev, slab_l, out_l, local_fn,
                              shape, "complex64", float(flops))
