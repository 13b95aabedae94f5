"""Distributed transforms: the per-shard mode and global C2C FFTs.

Counterpart: ``regent_fft_tpu/parallel/distributed.py``.  Modes:

1. ``shards``: the reference's distributed mode
   (the reference's ``src/fft.rg:513-537``): the leading axis is split
   evenly over the mesh and every rank transforms its own block, with no
   communication (C2C, R2C and C2R);
2. ``slab``: one global N-D C2C FFT, the first axis distributed: transform
   the local axes, one all-to-all exchange (the distributed transpose),
   transform the former first axis (``transposed_out``/``transposed_in``:
   FFTW_MPI_TRANSPOSED_OUT/IN);
3. ``pencil``: a global 3-D C2C FFT over a 2-D mesh, two exchanges, each
   within one mesh axis's process group (AccFFT's GPU pencil
   decomposition, arXiv 1506.07933);
4. ``slab1d``: one vector over the mesh, the four-step n = R*C with three
   exchanges (two with ``scrambled_in``/``scrambled_out``).

The JAX plans take one global array under ``shard_map``.  On
``torch.distributed`` every rank is a process holding only its block, as in
FFTW-MPI, so a plan here is built collectively (every rank calls the
constructor with the same arguments) and takes the calling rank's local
input block and returns its local output block.  ``in_block(rank)`` and
``out_block(rank)`` are the slices of the global input and output a rank
holds, and equal the JAX plan's shardings cut to the true extents: FFTW's
default block ``ceil(n/p)`` (``mpi/block.c:39``), so the last ranks may hold
short or empty blocks.  Inside the plan each block is padded as the JAX
plan pads the global array, so every exchange is one equal split.

Each local stage is an unscaled plan core of the port (``plan._build_core``,
the single-device dispatch), so on the card the slab runs ``fft_fused2``
and ``fft_cols``, the pencil ``fft_last`` and ``fft_cols``, the rank-1 plan
``fft_axis0`` and ``fft_last``, and complex32 plans their bf16 instances.
Exchanges move one buffer holding both planes (bf16 for complex32, f64 for
complex128) through ``all_to_all_single``: NCCL for CUDA plans, gloo for CPU
plans.  A CUDA plan on a gloo group raises; nothing is staged through the
host.  The real global plans and the distributed r2r plans raise
``NotImplementedError`` (ROADMAP Queue 1 #12b).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..dtypes import (PLANE_DTYPES, Direction, Kind, Norm, SplitComplex,
                      as_real, as_split, check_dtype, from_split)
from .mesh import check_backend, make_fft_mesh, make_pencil_mesh, _world


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is ROADMAP Queue 1 #12b of the PyTorch port")


# ---------------------------------------------------------------------------
# Local stages, scales, blocks
# ---------------------------------------------------------------------------

class _LocalCore:
    """Unscaled plan core over ``axes`` of a rank's local block, through
    the single-device dispatch (``plan._build_core``, norm NONE).  The JAX
    core is polymorphic over batch extents; the port builds one plan per
    planes' shape it meets (pipeline chunks), the planned shape at once so
    its tables reach the card when the distributed plan is made.
    Counterpart: ``distributed.py:53`` (``_local_core``)."""

    def __init__(self, local_shape, axes, direction=Direction.FORWARD,
                 kind=Kind.C2C, precision: str = "highest",
                 use_3m: bool = False, max_radix: int = 128,
                 backend: str = "auto", dtype: str = "complex64",
                 device="cuda"):
        if kind == Kind.R2C:
            direction = Direction.FORWARD
        elif kind == Kind.C2R:
            direction = Direction.BACKWARD
        if kind != Kind.C2C:
            dtype = "complex64"   # real plans compute in f32
        self.axes = tuple(axes)
        self.kind = Kind(kind)
        self.fields = dict(direction=direction, precision=precision,
                           use_3m=use_3m, max_radix=max_radix,
                           backend=backend, dtype=dtype, device=str(device))
        self._plans = {}
        self.plan(tuple(local_shape))

    def plan(self, shape):
        """The core plan of ``shape`` (the real shape for R2C/C2R)."""
        from ..plan import PlanSpec, _build_core, _half_shape
        p = self._plans.get(shape)
        if p is None:
            spec = PlanSpec(shape=shape, axes=self.axes, kind=self.kind,
                            norm=Norm.NONE, **self.fields)
            p = _build_core(spec)
            key = _half_shape(spec) if self.kind == Kind.C2R else shape
            self._plans[key] = p
        return p

    @property
    def plans(self):
        return list(self._plans.values())

    def __call__(self, *planes):
        planes = [t.contiguous() for t in planes]
        p = self.plan(tuple(planes[0].shape))
        if self.kind == Kind.R2C:
            return p.execute_real(planes[0])
        return p.execute_split(*planes)


def _norm_scale(n: int, direction: Direction, norm: Norm) -> float:
    """Counterpart: ``distributed.py:92``."""
    if norm == Norm.NONE:
        return 1.0
    fwd = direction == Direction.FORWARD
    if norm == Norm.BACKWARD:
        return 1.0 if fwd else 1.0 / n
    if norm == Norm.FORWARD:
        return 1.0 / n if fwd else 1.0
    return 1.0 / math.sqrt(n)


def _apply_scale(xr, xi, scale):
    """Both planes times the scale rounded to their dtype.
    Counterpart: ``distributed.py:103``."""
    if scale != 1.0:
        s = float(torch.tensor(scale, dtype=xr.dtype))
        xr, xi = xr * s, xi * s
    return xr, xi


def _blk(n: int, p: int) -> int:
    """FFTW's ``XM(default_block)``: ceil(n/p), the last blocks short
    (``mpi/block.c:39``).  Counterpart: ``distributed.py:234``."""
    return -(-int(n) // int(p))


def _pad_axis(x, axis: int, to: int):
    """``x`` with ``axis`` zero-padded to ``to`` (an empty block too)."""
    cur = x.shape[axis]
    if cur == to:
        return x
    shape = list(x.shape)
    shape[axis] = to
    out = x.new_zeros(shape)
    out.narrow(axis, 0, cur).copy_(x)
    return out


def _slice_axis(x, axis: int, to: int):
    """``x`` cut to ``to`` along ``axis`` (a view)."""
    return x if x.shape[axis] == to else x.narrow(axis, 0, to)


def _chunked(n_chunks: int, extent: int):
    """Chunk slices along an axis for the overlap pipeline (1 = off).
    Counterpart: ``distributed.py:262``."""
    c = max(1, min(n_chunks, extent))
    while extent % c:
        c -= 1
    size = extent // c
    return [slice(k * size, (k + 1) * size) for k in range(c)]


# ---------------------------------------------------------------------------
# Mesh axes and the exchange
# ---------------------------------------------------------------------------

class _MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: its process group, its
    size, this rank's coordinate, and ``perm[g]`` = the mesh position of
    the group's rank g (None where group order is mesh order)."""

    name: str
    group: object
    size: int
    coord: int
    perm: Optional[Tuple[int, ...]]


def _mesh_axis(mesh, name: str) -> _MeshAxis:
    dim = list(mesh.mesh_dim_names).index(name)
    group = mesh.get_group(name)
    coord = list(mesh.get_coordinate())
    line = []
    for k in range(mesh.mesh.shape[dim]):
        coord_k = list(coord)
        coord_k[dim] = k
        line.append(int(mesh.mesh[tuple(coord_k)]))
    ranks = dist.get_process_group_ranks(group)
    perm = tuple(line.index(r) for r in ranks)
    return _MeshAxis(name, group, len(line), coord[dim],
                     None if perm == tuple(range(len(line))) else perm)


def _coords(mesh, rank: int) -> dict:
    """{axis name: coordinate} of ``rank`` in ``mesh``."""
    pos = (mesh.mesh == int(rank)).nonzero()
    if pos.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return {n: int(c) for n, c in zip(mesh.mesh_dim_names, pos[0])}


class _Pending:
    """An exchange in flight; :meth:`wait` returns its planes."""

    def __init__(self, work, buf, out, finish):
        self.work, self.buf, self.out, self.finish = work, buf, out, finish

    def wait(self):
        self.work.wait()
        self.buf = None
        return self.finish(self.out)


def _exchange_start(planes, ax: _MeshAxis, split: int, concat: int,
                    into=None) -> _Pending:
    """Start ``lax.all_to_all(split_axis=split, concat_axis=concat,
    tiled=True)`` of every plane over ``ax``, all in one buffer: each plane
    is cut along ``split`` into ``ax.size`` chunks, chunk k goes to mesh
    position k, and the received chunks are laid along ``concat`` in mesh
    order.  ``all_to_all_single`` splits dim 0 only, so the send buffer is
    (p, planes, the chunk): every chunk keeps the array's axis order
    (runs along the axes after ``split`` stay contiguous, and at P = 1
    packing is one straight copy), and so does every received block.  The
    collective is called at every world size, one included.  ``into``:
    planes of this dtype whose storage may hold the result (``donate``).
    Counterpart: ``distributed.py:109`` (``_a2a``)."""
    from ..utils.plog import log_collective
    x0 = planes[0]
    p, n = ax.size, x0.shape[split]
    if n % p:
        raise ValueError(f"exchange of extent {n} over {p} ranks")
    m = n // p
    chunk = list(x0.shape)
    chunk[split] = m
    log_collective(f"all_to_all(split={split}, concat={concat})", ax.name,
                   x0.shape)
    buf = x0.new_empty([p, len(planes)] + chunk)
    for k, t in enumerate(planes):
        buf[:, k].copy_(t.unflatten(split, (p, m)).movedim(split, 0))
    if ax.perm is not None:
        buf = buf[list(ax.perm)]
    out = torch.empty_like(buf)
    work = dist.all_to_all_single(out, buf, group=ax.group, async_op=True)
    shape = list(chunk)
    shape[concat] *= p
    blocks = shape[:concat] + [p, chunk[concat]] + shape[concat + 1:]

    def finish(out):
        if ax.perm is not None:
            out = out[[ax.perm.index(k) for k in range(p)]]
        res = []
        for k in range(len(planes)):
            dst = None
            if into is not None and k < len(into):
                t = into[k]
                if (t.dtype == out.dtype and t.is_contiguous()
                        and t.numel() == math.prod(shape)):
                    dst = t.view(shape)
            if dst is None:
                dst = out.new_empty(shape)
            dst.view(blocks).movedim(concat, 0).copy_(out[:, k])
            res.append(dst)
        return res
    return _Pending(work, buf, out, finish)


def _a2a(xr, xi, ax: _MeshAxis, split: int, concat: int, into=None):
    """The exchange of both planes, waited for.
    Counterpart: ``distributed.py:109``."""
    return tuple(_exchange_start([xr, xi], ax, split, concat, into).wait())


def _pipeline(xr, xi, axis: int, slices, start, finish):
    """Chunks of (xr, xi) along ``axis``: chunk k+1's exchange is issued
    (``start`` returns a pending exchange) before chunk k's ``finish``
    (its FFT) runs; the results are laid back along ``axis``."""
    if len(slices) == 1:
        return finish(*start(xr, xi).wait())
    pre = (slice(None),) * axis
    pend = start(xr[pre + (slices[0],)], xi[pre + (slices[0],)])
    outs = []
    for k in range(len(slices)):
        nxt = None
        if k + 1 < len(slices):
            sl = pre + (slices[k + 1],)
            nxt = start(xr[sl], xi[sl])
        outs.append(finish(*pend.wait()))
        pend = nxt
    return (torch.cat([o[0] for o in outs], axis),
            torch.cat([o[1] for o in outs], axis))


class _Layout(NamedTuple):
    """A global array's distribution: its true shape, the mesh axis each
    array axis is split over (None: whole), and the padded local length
    of each axis (the block, or the true length where whole)."""

    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    blk: Tuple[int, ...]

    def block(self, coords: dict) -> Tuple[slice, ...]:
        out = []
        for n, a, b in zip(self.shape, self.spec, self.blk):
            if a is None:
                out.append(slice(0, n))
            else:
                c = coords[a]
                out.append(slice(min(c * b, n), min((c + 1) * b, n)))
        return tuple(out)

    def local_shape(self, coords: dict) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.block(coords))

    def pad(self, x):
        for ax, b in enumerate(self.blk):
            x = _pad_axis(x, ax, b)
        return x

    def crop(self, x, local_shape):
        for ax, n in enumerate(local_shape):
            x = _slice_axis(x, ax, n)
        return x.contiguous()


def _layout(shape, split: dict) -> _Layout:
    """{array axis: (mesh axis name, block)} -> _Layout."""
    shape = tuple(int(s) for s in shape)
    return _Layout(shape, tuple(split.get(i, (None, 0))[0]
                                for i in range(len(shape))),
                   tuple(split[i][1] if i in split else n
                         for i, n in enumerate(shape)))


def _setup(mesh, device, make_mesh):
    """The plan's device and mesh: the world's backend checked against
    the device first (a CUDA plan needs NCCL), then the mesh (made by
    ``make_mesh(device_type)`` when None) and its groups."""
    from ..plan import resolve_device
    dev_type = torch.device(device).type
    _world()
    check_backend(None, dev_type)
    if mesh is None:
        mesh = make_mesh(dev_type)
    if mesh.device_type != dev_type:
        raise ValueError(f"a {dev_type} plan over a {mesh.device_type} mesh")
    for name in mesh.mesh_dim_names:
        check_backend(mesh.get_group(name), dev_type)
    return mesh, resolve_device(device)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

class DistributedFFTPlan:
    """A distributed plan: the calling rank's local block in, its local
    block out.

    ``global_shape`` (the JAX plan's), ``in_shape``/``out_shape`` (the
    global input and output), ``local_in_shape``/``local_out_shape``
    (this rank's blocks), :meth:`in_block`/:meth:`out_block` (any rank's
    slices of the global arrays), ``in_spec``/``out_spec`` (the mesh axis
    each array axis is split over, as the JAX PartitionSpecs).  Calling
    takes a numpy array, tensor or ``SplitComplex`` of the local block and
    returns the plan dtype's representation on the plan's device;
    :meth:`execute_split` takes and returns contiguous planes.
    Counterpart: ``distributed.py:264``."""

    def __init__(self, description: str, mesh, device, in_layout: _Layout,
                 out_layout: _Layout, fn: Callable, global_shape, dtype: str,
                 flops: float, donate: bool = False, cores=()):
        self.description = description
        self.mesh = mesh
        self.device = device
        self._in, self._out = in_layout, out_layout
        self._fn = fn
        self.global_shape = tuple(global_shape)
        self.in_shape, self.out_shape = in_layout.shape, out_layout.shape
        self.in_spec, self.out_spec = in_layout.spec, out_layout.spec
        self.dtype = check_dtype(dtype)
        self.flops = flops
        self.donate = bool(donate)
        coords = _coords(mesh, dist.get_rank())
        self.local_in_shape = in_layout.local_shape(coords)
        self.local_out_shape = out_layout.local_shape(coords)
        self.cores = [p for c in cores for p in c.plans]
        self._destroyed = False
        from ..utils.plog import log_plan
        log_plan(self)

    def in_block(self, rank: int) -> Tuple[slice, ...]:
        """The slices of the global input that ``rank`` holds."""
        return self._in.block(_coords(self.mesh, rank))

    def out_block(self, rank: int) -> Tuple[slice, ...]:
        """The slices of the global output that ``rank`` holds."""
        return self._out.block(_coords(self.mesh, rank))

    def plane_dtype(self) -> torch.dtype:
        """bf16 planes for complex32, f64 for complex128, else f32."""
        return PLANE_DTYPES[self.dtype]

    def _check(self):
        if self._destroyed:
            raise RuntimeError("plan was destroyed")

    def execute_split(self, xr: torch.Tensor, xi: torch.Tensor):
        """Local input planes (``local_in_shape``, :meth:`plane_dtype`, on
        the plan's device) -> local output planes.  With ``donate`` the
        plan may write into the storage of ``xr``/``xi``."""
        self._check()
        yr, yi = self._fn(self._in.pad(xr), self._in.pad(xi), xr, xi)
        return (self._out.crop(yr, self.local_out_shape),
                self._out.crop(yi, self.local_out_shape))

    def _input(self, x) -> SplitComplex:
        self._check()
        sx = as_split(x, self.device, self.plane_dtype())
        if sx.shape != self.local_in_shape:
            raise ValueError(f"local input shape {sx.shape} != planned "
                             f"{self.local_in_shape}")
        return sx

    def __call__(self, x):
        sx = self._input(x)
        return from_split(SplitComplex(*self.execute_split(sx.re, sx.im)),
                          self.dtype)

    execute = __call__

    def print_plan(self):
        print(self.description)

    def __repr__(self):
        return f"DistributedFFTPlan{self.description}"

    def destroy(self):
        self._destroyed = True
        self._fn = None


def _mesh_desc(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def make_plan_shards(shape, kind=Kind.C2C, direction=Direction.FORWARD,
                     norm=Norm.NONE, dtype="complex64", mesh=None,
                     axis_name: str = "fft", precision: str = "highest",
                     use_3m: bool = False, max_radix: int = 128,
                     backend: str = "auto", donate: bool = False,
                     device="cuda") -> DistributedFFTPlan:
    """The reference's distributed mode: the leading axis split evenly
    over the mesh, every rank a full rank-ndim transform of its own block,
    no communication (``src/fft.rg:513-537``), so a 1-D plan is P
    independent length-(n/P) FFTs.  ``kind=R2C``/``C2R``: a local
    rfftn/irfftn of each block, the last axis halved at its local length;
    for C2R ``shape`` is the real output shape.
    Counterpart: ``distributed.py:339``."""
    kind, direction, norm = Kind(kind), Direction(direction), Norm(norm)
    if kind not in (Kind.C2C, Kind.R2C, Kind.C2R):
        raise ValueError(f"shards mode supports C2C/R2C/C2R, got {kind}")
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    p = int(mesh.mesh.shape[0])
    shape = tuple(int(s) for s in shape)
    if shape[0] % p != 0:
        raise ValueError(f"leading axis {shape[0]} not divisible by mesh "
                         f"size {p}")
    local_shape = (shape[0] // p,) + shape[1:]
    axes = tuple(range(len(shape)))
    n_local = int(np.prod(local_shape))
    if kind == Kind.R2C:
        direction = Direction.FORWARD
    elif kind == Kind.C2R:
        direction = Direction.BACKWARD
    scale = _norm_scale(n_local, direction, norm)
    core = _LocalCore(local_shape, axes, direction, kind=kind,
                      precision=precision, use_3m=use_3m,
                      max_radix=max_radix, backend=backend, dtype=dtype,
                      device=dev)
    local_half = local_shape[:-1] + (local_shape[-1] // 2 + 1,)
    half_global = ((p * local_half[0],) + local_half[1:]
                   if len(shape) == 1 else (shape[0],) + local_half[1:])
    real_l = _layout(shape, {0: (name, local_shape[0])})
    half_l = _layout(half_global, {0: (name, local_half[0])})
    mesh_desc = _mesh_desc(mesh)
    flops_conv = 2.5 if kind != Kind.C2C else 5.0
    flops = p * flops_conv * n_local * max(1.0, math.log2(max(n_local, 2)))

    if kind == Kind.C2C:
        def local_fn(xr, xi, xr0, xi0):
            yr, yi = _apply_scale(*core(xr, xi), scale)
            if donate and xr0.dtype == yr.dtype and xr0.is_contiguous() \
                    and xi0.is_contiguous():
                return xr0.copy_(yr), xi0.copy_(yi)
            return yr, yi

        desc = (f"(plan-distrib-shards shape={shape} mesh={mesh_desc} "
                f"independent {len(shape)}D FFT of each local {local_shape} "
                f"slab, no collectives)")
        return DistributedFFTPlan(desc, mesh, dev, real_l, real_l, local_fn,
                                  shape, dtype, flops, donate, [core])

    if kind == Kind.R2C:
        desc = (f"(plan-distrib-shards-r2c real-shape={shape} "
                f"mesh={mesh_desc} independent local rfftn of each "
                f"{local_shape} slab -> local half {local_half}, "
                f"no collectives)")
        return _ShardsR2C(desc, mesh, dev, real_l, half_l,
                          lambda x: _apply_scale(*core(x), scale),
                          half_global, dtype, flops, donate, [core])

    def c2r_fn(xr, xi):
        y = core(xr, xi)
        if scale != 1.0:
            y = y * float(torch.tensor(scale, dtype=y.dtype))
        return y

    desc = (f"(plan-distrib-shards-c2r real-shape={shape} mesh={mesh_desc} "
            f"independent local irfftn of each {local_half} half slab, "
            f"no collectives)")
    return _ShardsC2R(desc, mesh, dev, half_l, real_l, c2r_fn, shape, dtype,
                      flops, donate, [core])


class _ShardsR2C(DistributedFFTPlan):
    """Real local block in (f32), half-spectrum block out (complex64)."""

    def plane_dtype(self):
        return torch.float32

    def execute_real(self, x: torch.Tensor):
        self._check()
        return self._fn(x)

    def execute_split(self, xr, xi):
        raise TypeError("an R2C plan takes one real plane: execute_real")

    def __call__(self, x):
        self._check()
        x = as_real(x, self.device, torch.float32)
        if tuple(x.shape) != self.local_in_shape:
            raise ValueError(f"local input shape {tuple(x.shape)} != planned "
                             f"{self.local_in_shape}")
        return from_split(SplitComplex(*self.execute_real(x)), "complex64")

    execute = __call__


class _ShardsC2R(DistributedFFTPlan):
    """Half-spectrum local block in (f32 planes), real block out (f32)."""

    def plane_dtype(self):
        return torch.float32

    def execute_split(self, xr, xi):
        self._check()
        return self._fn(xr, xi)

    def __call__(self, x):
        sx = self._input(x)
        return self.execute_split(sx.re, sx.im)

    execute = __call__


def make_plan_slab(shape, direction=Direction.FORWARD, norm=Norm.BACKWARD,
                   dtype="complex64", mesh=None, axis_name: str = "fft",
                   transposed_out: bool = False, transposed_in: bool = False,
                   precision: str = "highest", use_3m: bool = False,
                   max_radix: int = 128, backend: str = "auto",
                   pipeline_chunks: int = 1, howmany: int = 1,
                   donate: bool = False,
                   device="cuda") -> DistributedFFTPlan:
    """One global N-D C2C FFT, slab-decomposed over the first axis.

    Local FFT over axes 1..nd-1, one exchange trading the first axis for
    the last, FFT over the former first axis, and (unless
    ``transposed_out``) an exchange back.  ``transposed_out`` leaves the
    result split over the last axis (FFTW_MPI_TRANSPOSED_OUT);
    ``transposed_in`` takes input split over the last axis and needs one
    exchange (FFTW_MPI_TRANSPOSED_IN); the two are exclusive.
    ``pipeline_chunks`` (rank >= 3) cuts the exchange and FFT of the first
    axis into chunks along axis 1, chunk k+1's exchange in flight
    (``async_op``) while chunk k is transformed.  ``howmany`` adds a
    leading batch axis of independent transforms, moved in the same
    exchanges.  Non-divisible axes are uneven blocks (FFTW
    ``mpi/block.c:39``), padded inside the plan.  ``donate``: the first
    exchange may write into the caller's input planes.
    Counterpart: ``distributed.py:470``."""
    direction, norm = Direction(direction), Norm(norm)
    if transposed_in and transposed_out:
        raise ValueError("transposed_in and transposed_out are exclusive "
                         "(the single-collective pipeline cannot skip its "
                         "only all_to_all)")
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    ax = _mesh_axis(mesh, name)
    p = ax.size
    shape = tuple(int(s) for s in shape)
    nd_ = len(shape)
    if nd_ < 2:
        raise ValueError("slab decomposition needs rank >= 2")
    n0, nl = shape[0], shape[-1]
    b0, bl = _blk(n0, p), _blk(nl, p)
    n0p, nlp = p * b0, p * bl
    uneven0, unevenl = n0p != n0, nlp != nl
    howmany = int(howmany)
    off = 1 if howmany > 1 else 0
    bshape = ((howmany,) if off else ()) + shape
    n_total = int(np.prod(shape))
    scale = _norm_scale(n_total, direction, norm)
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, dtype=dtype, device=dev)
    core_local = _LocalCore(bshape[:off] + (b0,) + shape[1:],
                            range(off + 1, off + nd_), direction, **core_kw)
    core_ax0 = _LocalCore(bshape[:off] + (n0,) + shape[1:-1] + (bl,),
                          (off,), direction, **core_kw)
    chunks = pipeline_chunks if nd_ >= 3 else 1
    ax0, axl = off, off + nd_ - 1
    flops = max(howmany, 1) * 5.0 * n_total * math.log2(max(n_total, 2))
    unv = f" [uneven blocks {n0}->{n0p}|{nl}->{nlp}]" \
        if (uneven0 or unevenl) else ""
    slab_l = _layout(bshape, {ax0: (name, b0)})
    last_l = _layout(bshape, {axl: (name, bl)})
    cores = [core_local, core_ax0]

    def into(xr0, xi0):
        return (xr0, xi0) if donate else None

    if transposed_in:
        def local_fn(xr, xi, xr0, xi0):
            xr, xi = core_ax0(xr, xi)
            xr, xi = _pad_axis(xr, ax0, n0p), _pad_axis(xi, ax0, n0p)
            xr, xi = _a2a(xr, xi, ax, ax0, axl, into(xr0, xi0))
            xr, xi = _slice_axis(xr, axl, nl), _slice_axis(xi, axl, nl)
            return _apply_scale(*core_local(xr, xi), scale)

        desc = (f"(plan-distrib-slab shape={shape} P={p} axis={name} "
                f"{f'howmany={howmany} ' if off else ''}"
                f"[transposed input] fft(axis0) -> all_to_all(ICI) -> "
                f"local-{nd_-1}ax-fft{unv})")
        return DistributedFFTPlan(desc, mesh, dev, last_l, slab_l, local_fn,
                                  bshape, dtype, flops, donate, cores)

    chunk_ax = off + 1

    def local_fn(xr, xi, xr0, xi0):
        xr, xi = core_local(xr, xi)
        if unevenl:
            xr, xi = _pad_axis(xr, axl, nlp), _pad_axis(xi, axl, nlp)
        slices = _chunked(chunks, xr.shape[chunk_ax])
        dst = into(xr0, xi0) if len(slices) == 1 else None

        def start(cr, ci):
            return _exchange_start([cr, ci], ax, axl, ax0, dst)

        def finish(cr, ci):
            if uneven0:
                cr, ci = _slice_axis(cr, ax0, n0), _slice_axis(ci, ax0, n0)
            cr, ci = core_ax0(cr, ci)
            if not transposed_out:
                if uneven0:
                    cr, ci = _pad_axis(cr, ax0, n0p), _pad_axis(ci, ax0, n0p)
                cr, ci = _a2a(cr, ci, ax, ax0, axl)
            return cr, ci

        xr, xi = _pipeline(xr, xi, chunk_ax, slices, start, finish)
        return _apply_scale(xr, xi, scale)

    desc = (f"(plan-distrib-slab shape={shape} P={p} axis={name} "
            f"{f'howmany={howmany} ' if off else ''}"
            f"local-{nd_-1}ax-fft -> all_to_all(ICI) -> fft(axis0)"
            f"{' [transposed output]' if transposed_out else ' -> all_to_all back'}"
            f"{f' [pipelined x{chunks}]' if chunks > 1 else ''}{unv})")
    return DistributedFFTPlan(desc, mesh, dev, slab_l,
                              last_l if transposed_out else slab_l, local_fn,
                              bshape, dtype, flops, donate, cores)


def make_plan_slab_r2c(*args, **kwargs):
    """Counterpart: ``distributed.py:647``."""
    _unported("make_plan_slab_r2c")


def make_plan_slab_c2r(*args, **kwargs):
    """Counterpart: ``distributed.py:781``."""
    _unported("make_plan_slab_c2r")


def make_plan_pencil_r2c(*args, **kwargs):
    """Counterpart: ``distributed.py:1419``."""
    _unported("make_plan_pencil_r2c")


def make_plan_pencil_c2r(*args, **kwargs):
    """Counterpart: ``distributed.py:1559``."""
    _unported("make_plan_pencil_c2r")


def unpack_halfcomplex_rank1(y):
    """Counterpart: ``distributed.py:1078``."""
    _unported("unpack_halfcomplex_rank1 (the real rank-1 plans)")


def pack_halfcomplex_rank1(h):
    """Counterpart: ``distributed.py:1090``."""
    _unported("pack_halfcomplex_rank1 (the real rank-1 plans)")


def make_plan_slab_r2r(*args, **kwargs):
    """Counterpart: ``regent_fft_tpu/parallel/distributed_r2r.py``."""
    _unported("make_plan_slab_r2r (distributed r2r)")


def _slab1d_factors(n: int, p: int) -> Tuple[int, int]:
    """n = R*C with P | R and P | C, R nearest sqrt(n).
    Counterpart: ``distributed.py:920``."""
    best = None
    r = p
    while r * p <= n:
        if n % r == 0 and (n // r) % p == 0:
            if best is None or abs(r - math.isqrt(n)) < abs(best - math.isqrt(n)):
                best = r
        r += p
    if best is None:
        raise ValueError(
            f"distributed 1-D FFT needs n = R*C with {p} | R and {p} | C; "
            f"n={n} has no such split on P={p} devices")
    return best, n // best


def make_plan_slab_1d(n, direction=Direction.FORWARD, norm=Norm.BACKWARD,
                      dtype="complex64", mesh=None, axis_name: str = "fft",
                      factors: Optional[Tuple[int, int]] = None,
                      scrambled_in: bool = False, scrambled_out: bool = False,
                      precision: str = "highest", use_3m: bool = False,
                      max_radix: int = 128, backend: str = "auto",
                      kind: Kind = Kind.C2C, donate: bool = False,
                      device="cuda") -> DistributedFFTPlan:
    """Distributed 1-D C2C FFT of one vector (FFTW's rank-1 MPI solver,
    ``mpi/dft-rank1-bigvec.c``) as the four-step n = R*C over the mesh:
    view x as the row-major (R, C) matrix, exchange, FFT_R on the columns,
    twiddle w^(k1*c), exchange, FFT_C on the rows, and a global transpose
    for natural order.  ``scrambled_out`` skips the transpose (element
    (k1, k2) of the (R, C) grid holds X[k1 + R*k2]); ``scrambled_in``
    takes that order; 2 exchanges instead of 3.  The (R, C) twiddle is
    computed on the host in float64, each rank holding its columns.
    The real kinds are ROADMAP Queue 1 #12b.
    Counterpart: ``distributed.py:935``."""
    direction, norm = Direction(direction), Norm(norm)
    if scrambled_in and scrambled_out:
        raise ValueError("scrambled_in and scrambled_out are exclusive "
                         "(use one natural boundary per plan)")
    if Kind(kind) != Kind.C2C:
        _unported(f"the rank-1 {Kind(kind).value} plan")
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    ax = _mesh_axis(mesh, name)
    p = ax.size
    n = int(n)
    if n % p:
        raise ValueError(f"n={n} not divisible by mesh size {p}")
    R, C = factors if factors is not None else _slab1d_factors(n, p)
    R, C = int(R), int(C)
    if R * C != n or R % p or C % p:
        raise ValueError(f"factors {(R, C)} invalid: need R*C={n}, "
                         f"{p} | R, {p} | C")
    scale = _norm_scale(n, direction, norm)
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, dtype=dtype, device=dev)
    core_R = _LocalCore((R, C // p), (0,), direction, **core_kw)
    core_C = _LocalCore((R // p, C), (1,), direction, **core_kw)
    sign = float(int(direction))
    cols = np.arange(ax.coord * (C // p), (ax.coord + 1) * (C // p),
                     dtype=np.float64)[None, :]
    theta = sign * 2.0 * np.pi * (np.arange(R, dtype=np.float64)[:, None]
                                  * cols) / n
    plane_dt = PLANE_DTYPES[check_dtype(dtype)]
    tw_r = torch.from_numpy(np.cos(theta)).to(device=dev, dtype=plane_dt)
    tw_i = torch.from_numpy(np.sin(theta)).to(device=dev, dtype=plane_dt)

    def _twiddle(ar, ai):
        return ar * tw_r - ai * tw_i, ar * tw_i + ai * tw_r

    def into(xr0, xi0):
        return (xr0, xi0) if donate else None

    if scrambled_in:
        def local_fn(xr, xi, xr0, xi0):
            xr, xi = core_C(xr.reshape(R // p, C), xi.reshape(R // p, C))
            xr, xi = _a2a(xr, xi, ax, 1, 0, into(xr0, xi0))
            xr, xi = core_R(*_twiddle(xr, xi))
            xr, xi = _a2a(xr, xi, ax, 0, 1)
            xr, xi = _apply_scale(xr, xi, scale)
            return xr.reshape(-1), xi.reshape(-1)
    else:
        def local_fn(xr, xi, xr0, xi0):
            xr, xi = xr.reshape(R // p, C), xi.reshape(R // p, C)
            xr, xi = _a2a(xr, xi, ax, 1, 0, into(xr0, xi0))
            xr, xi = _twiddle(*core_R(xr, xi))
            xr, xi = core_C(*_a2a(xr, xi, ax, 0, 1))
            if not scrambled_out:
                xr, xi = _a2a(xr, xi, ax, 1, 0)
                xr, xi = xr.transpose(0, 1), xi.transpose(0, 1)
            xr, xi = _apply_scale(xr, xi, scale)
            return xr.reshape(-1), xi.reshape(-1)

    vec_l = _layout((n,), {0: (name, n // p)})
    ncoll = 2 if (scrambled_in or scrambled_out) else 3
    desc = (f"(plan-distrib-1d n={n}={R}x{C} P={p} four-step over ICI, "
            f"{ncoll} collectives"
            f"{' [scrambled in]' if scrambled_in else ''}"
            f"{' [scrambled out]' if scrambled_out else ''})")
    flops = 5.0 * n * math.log2(max(n, 2))
    return DistributedFFTPlan(desc, mesh, dev, vec_l, vec_l, local_fn, (n,),
                              dtype, flops, donate, [core_R, core_C])


def make_plan_pencil(shape, direction=Direction.FORWARD, norm=Norm.BACKWARD,
                     dtype="complex64", mesh=None,
                     mesh_shape: Optional[Tuple[int, int]] = None,
                     axis_names: Tuple[str, str] = ("fy", "fz"),
                     transposed_out: bool = False,
                     precision: str = "highest", use_3m: bool = False,
                     max_radix: int = 128, backend: str = "auto",
                     pipeline_chunks: int = 1, pipeline_chunks2: int = 1,
                     howmany: int = 1, donate: bool = False,
                     device="cuda") -> DistributedFFTPlan:
    """One global 3-D C2C FFT, pencil-decomposed over a 2-D (P1, P2) mesh
    (FFTW's ``mpi/dft-rank-geq2-transposed.c``; AccFFT's GPU pencils):

        (Z/P1, Y/P2, X ) --fft X--> exchange[a2]: X<->Y --> (Z/P1, Y, X/P2)
                         --fft Y--> exchange[a1]: Y<->Z --> (Z, Y/P1, X/P2)
                         --fft Z--> [two exchanges back unless transposed_out]

    Each exchange runs in one mesh axis's process group.
    ``pipeline_chunks`` cuts the first exchange and fft(Y) into chunks
    along local Z, ``pipeline_chunks2`` the second and fft(Z) along local
    X, each chunk's exchange in flight while the previous is transformed.
    Over ``make_multislice_mesh`` the host axis is a1, so
    ``transposed_out`` pays one exchange across hosts.  Uneven blocks: Z
    pads to P1 blocks, Y to lcm(P1, P2) blocks, X to P2 blocks.
    ``howmany`` adds a leading batch axis.
    Counterpart: ``distributed.py:1263``."""
    direction, norm = Direction(direction), Norm(norm)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("pencil decomposition is for rank-3 transforms")

    def default(dev_type):
        ms = mesh_shape
        if ms is None:
            ms = _default_pencil_shape(_world())
        return make_pencil_mesh(ms, axis_names, device_type=dev_type)
    mesh, dev = _setup(mesh, device, default)
    a1, a2 = mesh.mesh_dim_names
    ax1, ax2 = _mesh_axis(mesh, a1), _mesh_axis(mesh, a2)
    p1, p2 = ax1.size, ax2.size
    z, y, x = shape
    lcm12 = p1 * p2 // math.gcd(p1, p2)
    zp = p1 * _blk(z, p1)
    yp = lcm12 * _blk(y, lcm12)
    xp = p2 * _blk(x, p2)
    unz, uny, unx = zp != z, yp != y, xp != x
    uneven = unz or uny or unx
    n_total = z * y * x
    howmany = int(howmany)
    off = 1 if howmany > 1 else 0
    bshape = ((howmany,) if off else ()) + shape
    scale = _norm_scale(n_total, direction, norm)
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, dtype=dtype, device=dev)
    b = bshape[:off]
    zsl1 = _chunked(pipeline_chunks, zp // p1)
    xsl2 = _chunked(pipeline_chunks2, xp // p2)
    core_x = _LocalCore(b + (zp // p1, yp // p2, x), (off + 2,), direction,
                        **core_kw)
    core_y = _LocalCore(b + ((zp // p1) // len(zsl1), y, xp // p2),
                        (off + 1,), direction, **core_kw)
    core_z = _LocalCore(b + (z, yp // p1, (xp // p2) // len(xsl2)), (off,),
                        direction, **core_kw)

    def local_fn(xr, xi, xr0, xi0):
        xr, xi = core_x(xr, xi)                           # (Z/P1, Y/P2, X)
        if unx:
            xr, xi = _pad_axis(xr, off + 2, xp), _pad_axis(xi, off + 2, xp)
        dst = (xr0, xi0) if donate and len(zsl1) == 1 else None

        def start1(cr, ci):
            return _exchange_start([cr, ci], ax2, off + 2, off + 1, dst)

        def finish1(cr, ci):
            if uny:
                cr, ci = _slice_axis(cr, off + 1, y), _slice_axis(ci, off + 1, y)
            cr, ci = core_y(cr, ci)
            if uny:
                cr, ci = _pad_axis(cr, off + 1, yp), _pad_axis(ci, off + 1, yp)
            return cr, ci

        def start2(cr, ci):
            return _exchange_start([cr, ci], ax1, off + 1, off)

        def finish2(cr, ci):
            if unz:
                cr, ci = _slice_axis(cr, off, z), _slice_axis(ci, off, z)
            return core_z(cr, ci)

        xr, xi = _pipeline(xr, xi, off, zsl1, start1, finish1)  # (Z/P1, Y, X/P2)
        xr, xi = _pipeline(xr, xi, off + 2, xsl2, start2, finish2)
        if not transposed_out:                            # (Z, Y/P1, X/P2)
            if unz:
                xr, xi = _pad_axis(xr, off, zp), _pad_axis(xi, off, zp)
            xr, xi = _a2a(xr, xi, ax1, off, off + 1)
            xr, xi = _a2a(xr, xi, ax2, off + 1, off + 2)
        return _apply_scale(xr, xi, scale)

    in_l = _layout(bshape, {off: (a1, zp // p1), off + 1: (a2, yp // p2)})
    out_l = (_layout(bshape, {off + 1: (a1, yp // p1), off + 2: (a2, xp // p2)})
             if transposed_out else in_l)
    desc = (f"(plan-distrib-pencil shape={shape} mesh=({p1}x{p2}) "
            f"{f'howmany={howmany} ' if off else ''}"
            f"fftX -> a2a[{a2}]"
            f"{f'/{len(zsl1)}chunks' if len(zsl1) > 1 else ''}"
            f" -> fftY -> a2a[{a1}]"
            f"{f'/{len(xsl2)}chunks' if len(xsl2) > 1 else ''}"
            f" -> fftZ"
            f"{' [transposed output]' if transposed_out else ' -> 2x a2a back'}"
            f"{f' [uneven blocks {z}->{zp}|{y}->{yp}|{x}->{xp}]' if uneven else ''})")
    flops = max(howmany, 1) * 5.0 * n_total * math.log2(max(n_total, 2))
    return DistributedFFTPlan(desc, mesh, dev, in_l, out_l, local_fn, bshape,
                              dtype, flops, donate, [core_x, core_y, core_z])


def destroy_plan_distrib(plan: DistributedFFTPlan):
    """Reference-parity destroy (``src/fft.rg:655-661``).
    Counterpart: ``distributed.py:1678``."""
    plan.destroy()


# ---------------------------------------------------------------------------
# Strategies and their wisdom (FFTW_MEASURE for the MPI layer)
# ---------------------------------------------------------------------------

# (shape, n_devices, direction, norm, kind) -> the winning strategy dict;
# utils/wisdom.py exports it under the JAX package's keys.
_DISTRIB_WISDOM: dict = {}


def _distrib_key(shape, n_devices: int, direction: Direction, norm: Norm,
                 kind: Kind = Kind.C2C):
    """Counterpart: ``distributed.py:1693``."""
    return (tuple(shape), int(n_devices), int(direction), Norm(norm).value,
            Kind(kind).value)


def strategy_name(strategy: dict) -> str:
    """Canonical short name, e.g. ``slab/c2`` or ``pencil2x4/c1``.
    Counterpart: ``distributed.py:1699``."""
    mode = strategy["mode"]
    c = strategy.get("pipeline_chunks", 1)
    c2 = strategy.get("pipeline_chunks2", 1)
    tail = f"/c{c}" + (f"/d{c2}" if c2 > 1 else "")
    if mode == "pencil" and "mesh_shape" in strategy:
        p1, p2 = strategy["mesh_shape"]
        return f"pencil{p1}x{p2}{tail}"
    return f"{mode}{tail}"


def _default_pencil_shape(n_devices: int) -> Tuple[int, int]:
    """Counterpart: ``distributed.py:1711``."""
    r = int(math.isqrt(n_devices))
    while n_devices % r:
        r -= 1
    return (r, n_devices // r)


def candidate_strategies(shape, n_devices: int,
                         chunk_candidates: Sequence[int] = (1, 2, 4),
                         kind: Kind = Kind.C2C):
    """Feasible decompositions of a global transform, in every kind (pure
    logic): slab at every chunk count its axis 1 admits (rank >= 2),
    pencil in both mesh orientations with first- and second-exchange
    chunks (rank 3, P > 1, a non-trivial mesh), slab1d for rank 1 when
    n (n/2 for the real kinds) splits as R*C with P | R, P | C.
    Counterpart: ``distributed.py:1718``."""
    kind = Kind(kind)
    shape = tuple(shape)
    nd_ = len(shape)
    p = int(n_devices)
    out = []
    if nd_ == 1:
        n1d = shape[0] if kind == Kind.C2C else shape[0] // 2
        try:
            _slab1d_factors(n1d, p)
        except ValueError:
            return out
        if kind != Kind.C2C and shape[0] % 2:
            return out
        out.append({"mode": "slab1d"})
        return out
    if kind in (Kind.R2C, Kind.C2R):
        if nd_ >= 3:
            out.append({"mode": "slab", "pipeline_chunks": 1})
        if nd_ == 3 and p > 1:
            p1, p2 = _default_pencil_shape(p)
            if p1 > 1:
                out.append({"mode": "pencil", "mesh_shape": (p1, p2),
                            "pipeline_chunks": 1})
        return out
    if nd_ >= 2:
        for c in chunk_candidates:
            if c == 1 or (nd_ >= 3 and c <= shape[1]):
                out.append({"mode": "slab", "pipeline_chunks": int(c)})
    if nd_ == 3 and p > 1:
        p1, p2 = _default_pencil_shape(p)
        if p1 > 1:
            z, y, x = shape
            for q1, q2 in dict.fromkeys([(p1, p2), (p2, p1)]):
                for c in chunk_candidates:
                    if c == 1 or c <= _blk(z, q1):
                        out.append({"mode": "pencil", "mesh_shape": (q1, q2),
                                    "pipeline_chunks": int(c)})
                xloc = _blk(x, q2)
                for c in chunk_candidates:
                    if 1 < c <= xloc and xloc % c == 0:
                        out.append({"mode": "pencil", "mesh_shape": (q1, q2),
                                    "pipeline_chunks": 1,
                                    "pipeline_chunks2": int(c)})
    return out


def build_strategy(strategy: dict, shape, direction=Direction.FORWARD,
                   norm=Norm.BACKWARD, n_devices: Optional[int] = None,
                   **kw) -> DistributedFFTPlan:
    """Build the distributed C2C plan a strategy dict describes (collective:
    every rank calls it alike); the plan's ``strategy`` is that dict.
    ``n_devices``, if given, must be the world size.  The real kinds are
    ROADMAP Queue 1 #12b, but for the shards mode.
    Counterpart: ``distributed.py:1776``."""
    s = dict(strategy)
    mode = s.pop("mode")
    kind = Kind(kw.pop("kind", Kind.C2C))
    if n_devices is not None and int(n_devices) != _world():
        raise ValueError(f"n_devices={n_devices}: a distributed plan spans "
                         f"the world of {_world()} ranks")
    if mode == "shards":
        s.pop("pipeline_chunks", None)
        plan = make_plan_shards(shape, kind=kind, direction=direction,
                                norm=norm, **kw)
    elif kind in (Kind.R2C, Kind.C2R):
        _unported(f"the distributed {kind.value} {mode} plan")
    elif mode == "slab1d":
        plan = make_plan_slab_1d(shape[0], direction=direction, norm=norm,
                                 **s, **kw)
    elif mode == "slab":
        plan = make_plan_slab(shape, direction=direction, norm=norm, **s,
                              **kw)
    elif mode == "pencil":
        ms = s.pop("mesh_shape", None)
        if ms is not None:
            ms = tuple(ms)
        elif n_devices is not None:
            ms = _default_pencil_shape(int(n_devices))
        plan = make_plan_pencil(shape, direction=direction, norm=norm,
                                mesh_shape=ms, **s, **kw)
    else:
        raise ValueError(f"unknown distributed strategy mode: {mode!r}")
    plan.strategy = dict(strategy)
    return plan


def make_plan_distributed(shape, direction=Direction.FORWARD,
                          norm=Norm.BACKWARD, n_devices: Optional[int] = None,
                          planner: str = "estimate", kind: Kind = Kind.C2C,
                          chunk_candidates: Sequence[int] = (1, 2, 4),
                          measure_iters: int = 3,
                          **kw) -> DistributedFFTPlan:
    """Auto-dispatching global plan: slab vs pencil vs overlap chunks.

    ``planner="estimate"``: the wisdom winner of (shape, ranks, direction,
    norm, kind) when one is recorded, else the feasible strategy with the
    least padded volume plus 10 % per extra exchange round (slab first at
    equal overhead).  ``planner="measure"``: race every feasible strategy
    on the mesh (``utils.measure.measure_distributed``: every rank takes
    the slowest rank's time, so all pick one winner), record it in
    distributed wisdom, and return the raced plan, the race's winner and
    {name: seconds} in its ``measurements``.  The real kinds are
    ROADMAP Queue 1 #12b.  Counterpart: ``distributed.py:1835``."""
    kind, direction, norm = Kind(kind), Direction(direction), Norm(norm)
    shape = tuple(shape)
    if kind != Kind.C2C:
        _unported(f"make_plan_distributed of kind {kind.value}")
    p = int(n_devices or _world())
    key = _distrib_key(shape, p, direction, norm, kind)
    if planner == "measure":
        from ..utils.measure import measure_distributed
        plans = {}
        winner, timings = measure_distributed(
            shape, direction=direction, norm=norm, n_devices=p, kind=kind,
            chunk_candidates=chunk_candidates, iters=measure_iters,
            install=True, plans_out=plans, **kw)
        plan = plans.get(strategy_name(winner)) or build_strategy(
            winner, shape, direction, norm, n_devices=p, kind=kind, **kw)
        plan.measurements = {"winner": dict(winner), "timings": timings}
        return plan
    hit = _DISTRIB_WISDOM.get(key)
    if hit is not None:
        return build_strategy(hit, shape, direction, norm, n_devices=p,
                              kind=kind, **kw)
    cands = candidate_strategies(shape, p, (1,), kind=kind)
    if not cands:
        raise ValueError(
            f"no feasible distributed decomposition for shape {shape} "
            f"({kind}) on {p} devices (see candidate_strategies for the "
            f"divisibility rules)")

    def pad_overhead(c):
        if c["mode"] == "slab":
            n0p = p * _blk(shape[0], p)
            nlp = p * _blk(shape[-1], p)
            return n0p * nlp / (shape[0] * shape[-1]) - 1.0
        if c["mode"] == "pencil":
            q1, q2 = c["mesh_shape"]
            z, y, x = shape
            lcm12 = q1 * q2 // math.gcd(q1, q2)
            return (q1 * _blk(z, q1) * lcm12 * _blk(y, lcm12)
                    * q2 * _blk(x, q2)) / (z * y * x) - 1.0
        return 0.0

    def rank_key(c):
        rounds = {"slab": 0, "slab1d": 0}.get(c["mode"], 1)
        return (pad_overhead(c) + 0.10 * rounds,
                c.get("pipeline_chunks", 1) != 1)
    return build_strategy(min(cands, key=rank_key), shape, direction, norm,
                          n_devices=p, kind=kind, **kw)
