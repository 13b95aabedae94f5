"""Distributed transpose plans, FFTW-MPI's user primitive.

Counterpart: ``regent_fft_tpu/parallel/transpose.py``
(``fftw_mpi_plan_transpose``/``fftw_mpi_plan_many_transpose``, FFTW's
``mpi/api.c:521-551``): one all-to-all exchange turns the row blocks of the
global (n0, n1) matrix into column blocks (every rank then holds
(n0, n1/P)), and a local transpose gives the (n1/P, n0) row block of the
transposed matrix.  ``howmany`` makes each element a trailing
tuple (FFTW's idiom for complex data: howmany=2 real tuples).

As every distributed plan of the port, it is built collectively and takes
the calling rank's local row block, (n0/P, n1[, howmany]), returning its
row block of the transpose, (n1/P, n0[, howmany]), in any dtype the
group's backend exchanges (complex included), on the plan's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import (_coords, _exchange_start, _layout, _mesh_axis,
                          _setup)
from .mesh import make_fft_mesh


class TransposePlan:
    """Global (n0, n1[, howmany]) -> (n1, n0[, howmany]) transpose over a
    1-D mesh, input and output row-block distributed.
    Counterpart: ``regent_fft_tpu/parallel/transpose.py:40``."""

    def __init__(self, n0: int, n1: int, howmany: int = 1, mesh=None,
                 axis_name: str = "fft", device="cuda"):
        mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
            axis_name=axis_name, device_type=t))
        name = mesh.mesh_dim_names[0]
        self._ax = _mesh_axis(mesh, name)
        p = self._ax.size
        n0, n1, howmany = int(n0), int(n1), int(howmany)
        if n0 % p or n1 % p:
            raise ValueError(
                f"transpose needs P | n0 and P | n1: ({n0}, {n1}) on P={p}")
        self.mesh, self.device = mesh, dev
        self.n0, self.n1, self.howmany = n0, n1, howmany
        trail = () if howmany == 1 else (howmany,)
        self.global_shape = (n0, n1) + trail
        self.out_shape = (n1, n0) + trail
        self._in = _layout(self.global_shape, {0: (name, n0 // p)})
        self._outl = _layout(self.out_shape, {0: (name, n1 // p)})
        self.in_spec, self.out_spec = self._in.spec, self._outl.spec
        coords = _coords(mesh, dist.get_rank())
        self.local_in_shape = self._in.local_shape(coords)
        self.local_out_shape = self._outl.local_shape(coords)
        self._destroyed = False
        self.description = (f"(plan-transpose {n0}x{n1}"
                            f"{f'x{howmany}' if howmany > 1 else ''} P={p} "
                            f"all_to_all + local swap)")
        from ..utils.plog import log_plan
        log_plan(self)

    def in_block(self, rank: int) -> Tuple[slice, ...]:
        return self._in.block(_coords(self.mesh, rank))

    def out_block(self, rank: int) -> Tuple[slice, ...]:
        return self._outl.block(_coords(self.mesh, rank))

    def __call__(self, x):
        if self._destroyed:
            raise RuntimeError("plan was destroyed")
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = torch.as_tensor(x).to(self.device)
        if tuple(x.shape) != self.local_in_shape:
            raise ValueError(f"local input shape {tuple(x.shape)} != planned "
                             f"{self.local_in_shape}")
        # (n0/P, n1, h) --exchange(split n1, concat n0)--> (n0, n1/P, h)
        y, = _exchange_start([x], self._ax, 1, 0).wait()
        return y.transpose(0, 1).contiguous()       # (n1/P, n0, h)

    execute = __call__

    def print_plan(self):
        print(self.description)

    def destroy(self):
        self._destroyed = True


def make_plan_transpose(n0: int, n1: int, mesh=None, axis_name: str = "fft",
                        device="cuda") -> TransposePlan:
    """``fftw_mpi_plan_transpose(n0, n1)``: plan the global (n0, n1) ->
    (n1, n0) transpose, input and output row-block distributed.
    Counterpart: ``transpose.py:107``."""
    return TransposePlan(n0, n1, 1, mesh, axis_name, device)


def make_plan_many_transpose(n0: int, n1: int, howmany: int, mesh=None,
                             axis_name: str = "fft",
                             device="cuda") -> TransposePlan:
    """``fftw_mpi_plan_many_transpose``: each element a contiguous
    ``howmany``-tuple (trailing axis).  Counterpart: ``transpose.py:115``."""
    return TransposePlan(n0, n1, howmany, mesh, axis_name, device)
