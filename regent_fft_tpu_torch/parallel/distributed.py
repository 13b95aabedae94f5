"""Distributed transforms: the per-shard mode and global FFTs.

Counterpart: ``regent_fft_tpu/parallel/distributed.py``.  Modes:

1. ``shards``: the reference's distributed mode
   (the reference's ``src/fft.rg:513-537``): the leading axis is split
   evenly over the mesh and every rank transforms its own block, with no
   communication (C2C, R2C and C2R);
2. ``slab``: one global N-D FFT, the first axis distributed: transform
   the local axes, one all-to-all exchange (the distributed transpose),
   transform the former first axis (``transposed_out``/``transposed_in``:
   FFTW_MPI_TRANSPOSED_OUT/IN); the real plans trade axis 0 for axis 1,
   so the halved last axis never crosses an exchange;
3. ``pencil``: a global 3-D FFT over a 2-D mesh, each exchange within one
   mesh axis's process group (AccFFT's GPU pencil decomposition, arXiv
   1506.07933); the real plans leave Z split over both mesh axes;
4. ``slab1d``: one vector over the mesh, the four-step n = R*C with three
   exchanges (two with ``scrambled_in``/``scrambled_out``); the real kinds
   run it at n/2 on the packed vector (``mpi/rdft-rank1-bigvec.c``).

Where the last axis n has ``r2c_packed_supported(n)`` and no block is
uneven, the real plans carry the half spectrum Nyquist-packed (n/2 wide,
the real Nyquist bin in bin 0's imaginary slot) through every exchange,
from the packed row kernels ``fft_last_r2c``/``ifft_last_c2r``, and
untangle (or tangle) bin 0 at the end (start) with a frequency reversal
over the split axis: a flip and two permutations between ranks.

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
host.  The distributed r2r plans are in ``distributed_r2r.py``.
"""
from __future__ import annotations

import logging
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..dtypes import (PLANE_DTYPES, Direction, Kind, Norm, SplitComplex,
                      as_real, as_split, check_dtype, from_split)
from ..ops import stockham_kernels as _sk
from ..utils import trace as _trace
from ..utils.plog import log_collective, logger as _log
from .mesh import check_backend, make_fft_mesh, make_pencil_mesh, _world


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
            with _trace.span("rft.build"):
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
    """Both planes times the scale rounded to their dtype, in an
    ``rft.scale`` span.  Counterpart: ``distributed.py:103``."""
    if scale != 1.0:
        with _trace.span("rft.scale"):
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
    """{axis name: coordinate} of ``rank`` in ``mesh``, and for a mesh of
    several axes {(every name): the row-major position}, the coordinate
    along an array axis split over all of them jointly (the JAX
    ``P((a1, a2))``)."""
    pos = (mesh.mesh == int(rank)).nonzero()
    if pos.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    names = tuple(mesh.mesh_dim_names)
    out = {n: int(c) for n, c in zip(names, pos[0])}
    if len(names) > 1:
        out[names] = int(np.ravel_multi_index(
            tuple(int(c) for c in pos[0]), tuple(mesh.mesh.shape)))
    return out


def _joint_axis(mesh) -> _MeshAxis:
    """Every axis of ``mesh`` as one, positions in row-major mesh order,
    over the world's group (a mesh spans the world, as every mesh maker
    builds it), with the permutation from group ranks to positions."""
    names = tuple(mesh.mesh_dim_names)
    line = [int(r) for r in mesh.mesh.reshape(-1)]
    if sorted(line) != list(range(dist.get_world_size())):
        raise ValueError(f"a joint mesh axis spans the world: mesh ranks "
                         f"{sorted(line)}")
    perm = tuple(line.index(r) for r in range(len(line)))
    return _MeshAxis(names, dist.group.WORLD, len(line),
                     _coords(mesh, dist.get_rank())[names],
                     None if perm == tuple(range(len(line))) else perm)


class _Pending:
    """An exchange in flight; :meth:`wait` returns its planes."""

    def __init__(self, work, buf, out, finish):
        self.work, self.buf, self.out, self.finish = work, buf, out, finish

    def wait(self):
        self.work.wait()
        self.buf = None
        with _trace.span("rft.exchange.unpack"):
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
    The send-buffer copies run in an ``rft.exchange.pack`` span, the
    collective in ``rft.exchange.a2a``, the copies out in
    ``rft.exchange.unpack`` (:meth:`_Pending.wait`); the (p-1)/p of the
    buffer that leaves the rank is counted in ``exchange_bytes``.
    Counterpart: ``distributed.py:109`` (``_a2a``)."""
    x0 = planes[0]
    p, n = ax.size, x0.shape[split]
    if n % p:
        raise ValueError(f"exchange of extent {n} over {p} ranks")
    m = n // p
    chunk = list(x0.shape)
    chunk[split] = m
    if _log.isEnabledFor(logging.DEBUG):
        log_collective(f"all_to_all(split={split}, concat={concat})",
                       ax.name, x0.shape)
    with _trace.span("rft.exchange.pack"):
        buf = x0.new_empty([p, len(planes)] + chunk)
        for k, t in enumerate(planes):
            buf[:, k].copy_(t.unflatten(split, (p, m)).movedim(split, 0))
        if ax.perm is not None:
            buf = buf[list(ax.perm)]
    _trace.COUNTS["exchange_bytes"] += buf.nbytes * (p - 1) // p
    out = torch.empty_like(buf)
    with _trace.span("rft.exchange.a2a"):
        work = dist.all_to_all_single(out, buf, group=ax.group,
                                      async_op=True)
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


def _ppermute(x, ax: _MeshAxis, what: str, dest: int, src: int):
    """``lax.ppermute`` of one tensor over ``ax``: this rank sends ``x`` to
    mesh position ``dest`` and returns what position ``src`` sent (every
    rank holds the same shape).  ``torch.distributed``'s ``send``/``recv``
    refuse the caller's own rank, which the permutation of a one-rank
    world or the middle of an odd one sends to, so it is one
    ``all_to_all_single`` whose split sizes are zero but for the peer;
    what leaves the rank (nothing where the peer is the rank itself) is
    counted in ``exchange_bytes``."""
    if _log.isEnabledFor(logging.DEBUG):
        log_collective(f"ppermute({what})", ax.name, x.shape)

    def grank(pos):
        return pos if ax.perm is None else ax.perm.index(pos)
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    sizes_in, sizes_out = [0] * ax.size, [0] * ax.size
    sizes_in[grank(dest)] = sizes_out[grank(src)] = flat.numel()
    if dest != ax.coord:
        _trace.COUNTS["exchange_bytes"] += flat.nbytes
    dist.all_to_all_single(out, flat, sizes_out, sizes_in, group=ax.group)
    return out.view(x.shape)


def _rev_freq_sharded(x, axis: int, ax: _MeshAxis):
    """x[k] -> x[(-k) mod n] along an axis split over ``ax`` (a joint axis
    in row-major mesh order included): the local flip sent to position
    p-1-q gives g[k] = x[n-1-k], and one row moved to the next position
    turns that into the modular reversal, bin 0 arriving from the last
    position.  Two permutations, one of them a single row.
    Counterpart: ``distributed.py:128``."""
    p, q = ax.size, ax.coord
    c = x.shape[axis]
    mirror = (p - 1 - q) % p
    g = _ppermute(x.flip(axis), ax, "q -> p-1-q", mirror, mirror)
    prev_last = _ppermute(g.narrow(axis, c - 1, 1), ax, "q -> q+1",
                          (q + 1) % p, (q - 1) % p)
    return torch.cat([prev_last, g.narrow(axis, 0, c - 1)], axis)


def _untangle_packed(yr, yi, loc_axes, sh_axis: int, ax: _MeshAxis):
    """Packed (..., n/2) planes -> (..., n/2+1) half spectrum, split over
    ``ax`` along ``sh_axis``: ``plan._unpack_nyquist`` with the reversal
    along the split axis by :func:`_rev_freq_sharded` (lane 0 only).
    Counterpart: ``distributed.py:152``."""
    from ..plan import _rev_freq
    with _trace.span("rft.layout.nyquist"):
        zr, zi = yr[..., 0], yi[..., 0]
        rr = _rev_freq_sharded(_rev_freq(zr, loc_axes), sh_axis, ax)
        ri = _rev_freq_sharded(_rev_freq(zi, loc_axes), sh_axis, ax)
        x0r, x0i = 0.5 * (zr + rr), 0.5 * (zi - ri)
        nqr, nqi = 0.5 * (zi + ri), -0.5 * (zr - rr)
        return (torch.cat([x0r[..., None], yr[..., 1:], nqr[..., None]], -1),
                torch.cat([x0i[..., None], yi[..., 1:], nqi[..., None]], -1))


def _tangle_packed(xr, xi, loc_axes, sh_axis: int, ax: _MeshAxis):
    """(..., n/2+1) half spectrum split over ``ax`` -> packed (..., n/2)
    planes: ``plan._pack_nyquist`` with the sharded reversal, the bin-0 and
    Nyquist slabs projected onto their conjugate-even parts first, so a
    non-Hermitian spectrum gives ``numpy.irfftn``'s answer.
    Counterpart: ``distributed.py:180``."""
    from ..plan import _rev_freq
    m = xr.shape[-1] - 1

    def herm(r, i):
        rr = _rev_freq_sharded(_rev_freq(r, loc_axes), sh_axis, ax)
        ri = _rev_freq_sharded(_rev_freq(i, loc_axes), sh_axis, ax)
        return 0.5 * (r + rr), 0.5 * (i - ri)

    with _trace.span("rft.layout.nyquist"):
        x0r, x0i = herm(xr[..., 0], xi[..., 0])
        nqr, nqi = herm(xr[..., m], xi[..., m])
        pr, pi = xr[..., :m].clone(), xi[..., :m].clone()
        pr[..., 0] = x0r - nqi
        pi[..., 0] = x0i + nqr
    return pr, pi


def _r2c_rows(x, scale: float = 1.0):
    """The packed R2C row kernel along the last axis of a real block:
    (..., n) -> (..., n/2) Nyquist-packed planes, ``scale`` fused
    (``fft_last_r2c``; its plain version on the host).
    Counterpart: ``fft_last_r2c_stockham(packed=True)``."""
    lead, n = x.shape[:-1], x.shape[-1]
    with _trace.span("rft.step.r2c"):
        yr, yi = _sk.fft_last_r2c(x.contiguous().reshape(-1, n), packed=True,
                                  scale=scale)
    return yr.view(lead + (n // 2,)), yi.view(lead + (n // 2,))


def _c2r_rows(xr, xi, n: int, scale: float = 1.0):
    """n times the inverse of :func:`_r2c_rows`, ``scale`` fused
    (``ifft_last_c2r``).  Counterpart: ``ifft_last_c2r_stockham(packed=True)``."""
    lead, m = xr.shape[:-1], xr.shape[-1]
    with _trace.span("rft.step.c2r"):
        y = _sk.ifft_last_c2r(xr.contiguous().reshape(-1, m),
                              xi.contiguous().reshape(-1, m), n, packed=True,
                              scale=scale)
    return y.view(lead + (n,))


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
        with _trace.span("rft.plan"):
            return self._split(xr, xi)

    def _split(self, xr, xi):
        self._check()
        yr, yi = self._fn(self._in.pad(xr), self._in.pad(xi), xr, xi)
        return (self._out.crop(yr, self.local_out_shape),
                self._out.crop(yi, self.local_out_shape))

    def _input(self, x) -> SplitComplex:
        self._check()
        with _trace.span("rft.layout.split"):
            sx = as_split(x, self.device, self.plane_dtype())
        if sx.shape != self.local_in_shape:
            raise ValueError(f"local input shape {sx.shape} != planned "
                             f"{self.local_in_shape}")
        return sx

    def __call__(self, x):
        with _trace.span("rft.plan"):
            sx = self._input(x)
            y = self._split(sx.re, sx.im)
            with _trace.span("rft.layout.combine"):
                return from_split(SplitComplex(*y), self.dtype)

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
        return _R2CPlan(desc, mesh, dev, real_l, half_l,
                        lambda x: _apply_scale(*core(x), scale),
                        half_global, dtype, flops, donate, [core])

    def c2r_fn(xr, xi):
        return _scaled(core(xr, xi), scale)

    desc = (f"(plan-distrib-shards-c2r real-shape={shape} mesh={mesh_desc} "
            f"independent local irfftn of each {local_half} half slab, "
            f"no collectives)")
    return _C2RPlan(desc, mesh, dev, half_l, real_l, c2r_fn, shape, dtype,
                    flops, donate, [core])


class _R2CPlan(DistributedFFTPlan):
    """Real local block in (f32, whatever the plan dtype, as the JAX
    ``_R2CPlan``), half-spectrum block out (complex64); ``fn(x)`` maps the
    padded real block to the padded output planes."""

    def plane_dtype(self):
        return torch.float32

    def execute_real(self, x: torch.Tensor):
        """The local real plane (``local_in_shape``, f32, on the plan's
        device) -> the local output planes."""
        with _trace.span("rft.plan"):
            return self._real(x)

    def _real(self, x):
        self._check()
        yr, yi = self._fn(self._in.pad(x))
        return (self._out.crop(yr, self.local_out_shape),
                self._out.crop(yi, self.local_out_shape))

    def execute_split(self, xr, xi):
        raise TypeError("an R2C plan takes one real plane: execute_real")

    def __call__(self, x):
        self._check()
        with _trace.span("rft.plan"):
            with _trace.span("rft.layout.split"):
                x = as_real(x, self.device, torch.float32)
            if tuple(x.shape) != self.local_in_shape:
                raise ValueError(f"local input shape {tuple(x.shape)} != "
                                 f"planned {self.local_in_shape}")
            y = self._real(x)
            with _trace.span("rft.layout.combine"):
                return from_split(SplitComplex(*y), "complex64")

    execute = __call__


class _C2RPlan(DistributedFFTPlan):
    """Half-spectrum local block in (f32 planes), real block out (f32);
    ``fn(xr, xi)`` maps the padded planes to the padded real block."""

    def plane_dtype(self):
        return torch.float32

    def _split(self, xr, xi):
        self._check()
        y = self._fn(self._in.pad(xr), self._in.pad(xi))
        return self._out.crop(y, self.local_out_shape)

    def __call__(self, x):
        with _trace.span("rft.plan"):
            sx = self._input(x)
            return self._split(sx.re, sx.im)

    execute = __call__


def _scaled(y, scale: float):
    """A real block times the norm scale rounded to its dtype, in an
    ``rft.scale`` span."""
    if scale != 1.0:
        with _trace.span("rft.scale"):
            y = y * float(torch.tensor(scale, dtype=y.dtype))
    return y


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


def make_plan_slab_r2c(shape, norm=Norm.BACKWARD, dtype="complex64",
                       mesh=None, axis_name: str = "fft",
                       transposed_out: bool = False,
                       precision: str = "highest", use_3m: bool = False,
                       max_radix: int = 128, backend: str = "auto",
                       donate: bool = False, device="cuda") -> _R2CPlan:
    """One global real-input N-D FFT (rank >= 3), slab-decomposed over the
    first axis.

    The last axis is halved locally, and the exchange trades axis 0 for
    axis 1, so the halved axis (n/2+1 values) never crosses it.  Where
    ``r2c_packed_supported(X)`` and no block is uneven the spectrum moves
    Nyquist-packed at X/2: ``fft_last_r2c(packed=True)``, the mid axes,
    the exchange, axis 0, the exchange back (unless ``transposed_out``),
    then the packed bin 0 untangled with the reversal over the split axis.
    Else: the local R2C core, the mid axes, the exchange on padded
    blocks, axis 0 at its true length, a crop.  The output is the half
    spectrum split over axis 1 with ``transposed_out``, else over axis 0.
    The input is real (f32 whatever ``dtype``; complex input raises
    ``TypeError``); ``donate`` is accepted and writes into nothing.
    Counterpart: ``distributed.py:647``."""
    norm = Norm(norm)
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    ax = _mesh_axis(mesh, name)
    p = ax.size
    shape = tuple(int(s) for s in shape)
    nd_ = len(shape)
    if nd_ < 3:
        raise ValueError("slab r2c needs rank >= 3 (use single-chip rfftn "
                         "below that)")
    n0, n1 = shape[0], shape[1]
    b0, b1 = _blk(n0, p), _blk(n1, p)
    n0p, n1p = p * b0, p * b1
    uneven0, uneven1 = n0p != n0, n1p != n1
    uneven = uneven0 or uneven1
    n_total = int(np.prod(shape))
    scale = _norm_scale(n_total, Direction.FORWARD, norm)
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, device=dev)
    local_real = (b0,) + shape[1:]
    xh = shape[-1] // 2 + 1
    mid_axes = tuple(range(1, nd_ - 1))
    packed = _sk.r2c_packed_supported(shape[-1]) and not uneven
    if packed:
        m = shape[-1] // 2
        core_mid = _LocalCore(local_real[:-1] + (m,), mid_axes,
                              Direction.FORWARD, **core_kw)
        core_z = _LocalCore((n0, n1 // p) + shape[2:-1] + (m,), (0,),
                            Direction.FORWARD, **core_kw)
        cores = [core_mid, core_z]
        if transposed_out:                                  # (Z, Y/P, m)
            sh_axis, loc_axes = 1, [0] + list(range(2, nd_ - 1))
        else:                                               # (Z/P, Y, m)
            sh_axis, loc_axes = 0, list(range(1, nd_ - 1))

        def local_fn(x):
            yr, yi = core_mid(*_r2c_rows(x, scale))
            yr, yi = core_z(*_a2a(yr, yi, ax, 1, 0))
            if not transposed_out:
                yr, yi = _a2a(yr, yi, ax, 0, 1)
            return _untangle_packed(yr, yi, loc_axes, sh_axis, ax)
    else:
        core_r2c = _LocalCore(local_real, (nd_ - 1,), kind=Kind.R2C,
                              **core_kw)
        core_mid = _LocalCore(local_real[:-1] + (xh,), mid_axes,
                              Direction.FORWARD, **core_kw)
        core_z = _LocalCore((n0, b1) + shape[2:-1] + (xh,), (0,),
                            Direction.FORWARD, **core_kw)
        cores = [core_r2c, core_mid, core_z]

        def local_fn(x):
            xr, xi = core_mid(*core_r2c(x))                 # halve X, mids
            if uneven1:   # axis 1 transformed: placeholder lanes
                xr, xi = _pad_axis(xr, 1, n1p), _pad_axis(xi, 1, n1p)
            xr, xi = _a2a(xr, xi, ax, 1, 0)
            if uneven0:   # axis 0 whole: its true length
                xr, xi = _slice_axis(xr, 0, n0), _slice_axis(xi, 0, n0)
            xr, xi = core_z(xr, xi)
            if not transposed_out:
                if uneven0:
                    xr, xi = _pad_axis(xr, 0, n0p), _pad_axis(xi, 0, n0p)
                xr, xi = _a2a(xr, xi, ax, 0, 1)
            return _apply_scale(xr, xi, scale)

    half = shape[:-1] + (xh,)
    out_l = (_layout(half, {1: (name, b1)}) if transposed_out
             else _layout(half, {0: (name, b0)}))
    desc = (f"(plan-distrib-slab-r2c real-shape={shape} half={half} P={p} "
            f"r2c(X)+fft(mid) -> a2a(Y<->Z) -> fft(Z)"
            f"{' [transposed output]' if transposed_out else ' -> a2a back'}"
            f"{f' [uneven blocks {n0}->{n0p}|{n1}->{n1p}]' if uneven else ''})")
    flops = 2.5 * n_total * math.log2(max(n_total, 2))
    return _R2CPlan(desc, mesh, dev, _layout(shape, {0: (name, b0)}), out_l,
                    local_fn, half, dtype, flops, donate, cores)


def make_plan_slab_c2r(shape, norm=Norm.BACKWARD, dtype="complex64",
                       mesh=None, axis_name: str = "fft",
                       transposed_in: bool = False,
                       precision: str = "highest", use_3m: bool = False,
                       max_radix: int = 128, backend: str = "auto",
                       donate: bool = False, device="cuda") -> _C2RPlan:
    """The inverse of :func:`make_plan_slab_r2c`: half spectrum -> real
    field; ``shape`` is the real output shape.  ``transposed_in`` takes
    the R2C plan's ``transposed_out`` layout (axis 1 split) and skips one
    exchange.  On the packed route the bin-0 and Nyquist slabs are
    projected onto their conjugate-even parts (over the split axis too)
    before they are packed into lane 0, so any spectrum gives
    ``numpy.irfftn``'s answer; ``ifft_last_c2r(packed=True)`` ends it.
    Counterpart: ``distributed.py:781``."""
    norm = Norm(norm)
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    ax = _mesh_axis(mesh, name)
    p = ax.size
    shape = tuple(int(s) for s in shape)
    nd_ = len(shape)
    if nd_ < 3:
        raise ValueError("slab c2r needs rank >= 3")
    n0, n1 = shape[0], shape[1]
    b0, b1 = _blk(n0, p), _blk(n1, p)
    n0p, n1p = p * b0, p * b1
    uneven0, uneven1 = n0p != n0, n1p != n1
    uneven = uneven0 or uneven1
    n_total = int(np.prod(shape))
    scale = _norm_scale(n_total, Direction.BACKWARD, norm)
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, device=dev)
    local_real = (b0,) + shape[1:]
    xh = shape[-1] // 2 + 1
    mid_axes = tuple(range(1, nd_ - 1))
    packed = _sk.r2c_packed_supported(shape[-1]) and not uneven
    if packed:
        m = shape[-1] // 2
        core_mid = _LocalCore(local_real[:-1] + (m,), mid_axes,
                              Direction.BACKWARD, **core_kw)
        core_z = _LocalCore((n0, n1 // p) + shape[2:-1] + (m,), (0,),
                            Direction.BACKWARD, **core_kw)
        cores = [core_mid, core_z]
        if transposed_in:                                   # (Z, Y/P, Xh)
            sh_axis, loc_axes = 1, [0] + list(range(2, nd_ - 1))
        else:                                               # (Z/P, Y, Xh)
            sh_axis, loc_axes = 0, list(range(1, nd_ - 1))

        def local_fn(xr, xi):
            xr, xi = _tangle_packed(xr, xi, loc_axes, sh_axis, ax)
            if not transposed_in:
                xr, xi = _a2a(xr, xi, ax, 1, 0)             # (Z, Y/P, m)
            xr, xi = _a2a(*core_z(xr, xi), ax, 0, 1)        # (Z/P, Y, m)
            return _c2r_rows(*core_mid(xr, xi), shape[-1], scale)
    else:
        core_c2r = _LocalCore(local_real, (nd_ - 1,), kind=Kind.C2R,
                              **core_kw)
        core_mid = _LocalCore(local_real[:-1] + (xh,), mid_axes,
                              Direction.BACKWARD, **core_kw)
        core_z = _LocalCore((n0, b1) + shape[2:-1] + (xh,), (0,),
                            Direction.BACKWARD, **core_kw)
        cores = [core_c2r, core_mid, core_z]

        def local_fn(xr, xi):
            if not transposed_in:
                if uneven1:   # placeholder lanes even the axis-1 split
                    xr, xi = _pad_axis(xr, 1, n1p), _pad_axis(xi, 1, n1p)
                xr, xi = _a2a(xr, xi, ax, 1, 0)
            if uneven0:       # axis 0 whole: drop the padded bins
                xr, xi = _slice_axis(xr, 0, n0), _slice_axis(xi, 0, n0)
            xr, xi = core_z(xr, xi)
            if uneven0:
                xr, xi = _pad_axis(xr, 0, n0p), _pad_axis(xi, 0, n0p)
            xr, xi = _a2a(xr, xi, ax, 0, 1)
            if uneven1:       # axis 1 whole: drop the padded bins
                xr, xi = _slice_axis(xr, 1, n1), _slice_axis(xi, 1, n1)
            return _scaled(core_c2r(*core_mid(xr, xi)), scale)

    half = shape[:-1] + (xh,)
    in_l = (_layout(half, {1: (name, b1)}) if transposed_in
            else _layout(half, {0: (name, b0)}))
    desc = (f"(plan-distrib-slab-c2r real-shape={shape} P={p} "
            f"{'[transposed input] ' if transposed_in else 'a2a -> '}"
            f"ifft(Z) -> a2a -> ifft(mid) -> c2r(X)"
            f"{' [nyquist-packed transport]' if packed else ''}"
            f"{f' [uneven blocks {n0}->{n0p}|{n1}->{n1p}]' if uneven else ''})")
    flops = 2.5 * n_total * math.log2(max(n_total, 2))
    return _C2RPlan(desc, mesh, dev, in_l, _layout(shape, {0: (name, b0)}),
                    local_fn, shape, dtype, flops, donate, cores)


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

    ``kind=R2C``/``C2R``: the rank-1 real transform
    (``mpi/rdft-rank1-bigvec.c``): the real vector packs as z[j] = x[2j] +
    i x[2j+1] where it lies, the natural-order four-step runs at m = n/2,
    and the Hermitian untangle X[k] = E[k] + W^k O[k] reverses over the
    mesh (:func:`_rev_freq_sharded`).  R2C returns the packed halfcomplex
    (m,) vector, bin m's real value in bin 0's imaginary slot
    (:func:`unpack_halfcomplex_rank1` gives numpy's (m+1,)); C2R takes it
    and returns n times the inverse (with ``norm=NONE``).  Real kinds need
    even n and natural order, and compute in f32.
    Counterpart: ``distributed.py:935``."""
    direction, norm = Direction(direction), Norm(norm)
    if scrambled_in and scrambled_out:
        raise ValueError("scrambled_in and scrambled_out are exclusive "
                         "(use one natural boundary per plan)")
    kind = Kind(kind)
    if kind != Kind.C2C:
        if scrambled_in or scrambled_out:
            raise ValueError("rank-1 real transforms need natural order "
                             "(the Hermitian untangle is index-based)")
        if int(n) % 2:
            raise ValueError(f"rank-1 {kind} needs even n, got {n}")
        return _make_plan_slab_1d_real(
            n, kind, norm, dtype, mesh, axis_name, factors,
            precision=precision, use_3m=use_3m, max_radix=max_radix,
            backend=backend, donate=donate, device=device)
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


def unpack_halfcomplex_rank1(y):
    """Packed rank-1 halfcomplex (m,) -> numpy's (m+1,) half spectrum:
    bin m's real value rides bin 0's imaginary slot (FFTW's R2HC packing,
    ``rdft/rdft.h``).  Counterpart: ``distributed.py:1078``."""
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    out = np.empty(y.shape[0] + 1, np.complex128)
    out[0] = y[0].real
    out[1:-1] = y[1:]
    out[-1] = y[0].imag
    return out


def pack_halfcomplex_rank1(h):
    """numpy's (m+1,) half spectrum -> the packed (m,) halfcomplex vector,
    the inverse of :func:`unpack_halfcomplex_rank1` (the endpoints'
    imaginary parts are dropped, as ``numpy.irfft`` does).
    Counterpart: ``distributed.py:1090``."""
    h = np.asarray(h.cpu() if isinstance(h, torch.Tensor) else h)
    out = np.array(h[:-1], np.complex64)
    out[0] = complex(h[0].real, h[-1].real)
    return out


def _make_plan_slab_1d_real(n, kind: Kind, norm, dtype, mesh,
                            axis_name: str, factors,
                            precision: str = "highest", use_3m: bool = False,
                            max_radix: int = 128, backend: str = "auto",
                            donate: bool = False, device="cuda"):
    """The rank-1 real plans of :func:`make_plan_slab_1d`.
    Counterpart: ``distributed.py:1100``."""
    mesh, dev = _setup(mesh, device, lambda t: make_fft_mesh(
        axis_name=axis_name, device_type=t))
    name = mesh.mesh_dim_names[0]
    ax = _mesh_axis(mesh, name)
    p = ax.size
    n = int(n)
    m = n // 2
    if m % p:
        raise ValueError(f"n/2={m} not divisible by mesh size {p}")
    R, C = factors if factors is not None else _slab1d_factors(m, p)
    R, C = int(R), int(C)
    if R * C != m or R % p or C % p:
        raise ValueError(f"factors {(R, C)} invalid: need R*C={m}, "
                         f"{p} | R, {p} | C")
    direction = (Direction.FORWARD if kind == Kind.R2C
                 else Direction.BACKWARD)
    scale = _norm_scale(n, direction, norm)
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, device=dev)
    core_R = _LocalCore((R, C // p), (0,), direction, **core_kw)
    core_C = _LocalCore((R // p, C), (1,), direction, **core_kw)
    sign = float(int(direction))
    mloc = m // p

    def host_table(theta):          # float64 on the host, rounded once
        return (torch.from_numpy(np.cos(theta)).to(dev, torch.float32),
                torch.from_numpy(np.sin(theta)).to(dev, torch.float32))
    # the four-step twiddle's columns of this rank, and the Hermitian
    # twiddle W^k = exp(sign 2 pi i k / n) at this rank's global k
    cols = np.arange(ax.coord * (C // p), (ax.coord + 1) * (C // p),
                     dtype=np.float64)[None, :]
    tw_r, tw_i = host_table(sign * 2.0 * np.pi
                            * (np.arange(R, dtype=np.float64)[:, None]
                               * cols) / m)
    kk = np.arange(ax.coord * mloc, (ax.coord + 1) * mloc, dtype=np.float64)
    hw_r, hw_i = host_table(sign * 2.0 * np.pi * kk / n)
    first = ax.coord == 0           # this rank holds global bin 0

    def fourstep(xr, xi):
        """The natural-order mesh four-step of make_plan_slab_1d at m."""
        xr, xi = xr.reshape(R // p, C), xi.reshape(R // p, C)
        xr, xi = core_R(*_a2a(xr, xi, ax, 1, 0))            # (R, C/P)
        xr, xi = xr * tw_r - xi * tw_i, xr * tw_i + xi * tw_r
        xr, xi = core_C(*_a2a(xr, xi, ax, 0, 1))            # (R/P, C)
        xr, xi = _a2a(xr, xi, ax, 1, 0)                     # (R, C/P)
        return (xr.transpose(0, 1).reshape(-1),
                xi.transpose(0, 1).reshape(-1))

    vec_l = _layout((n,), {0: (name, n // p)})
    half_l = _layout((m,), {0: (name, mloc)})
    flops = 2.5 * n * math.log2(max(n, 2))
    cores = [core_R, core_C]
    if kind == Kind.R2C:
        def local_fn(x):
            x2 = x.reshape(-1, 2)               # z[j] = x[2j] + i x[2j+1]
            zr, zi = fourstep(x2[:, 0], x2[:, 1])
            # E = (Z + conj Zrev) / 2, O = (Z - conj Zrev) / 2i
            rr = _rev_freq_sharded(zr, 0, ax)
            ri = _rev_freq_sharded(zi, 0, ax)
            er, ei = 0.5 * (zr + rr), 0.5 * (zi - ri)
            o_r, o_i = 0.5 * (zi + ri), -0.5 * (zr - rr)
            # X[k] = E[k] + W^k O[k], k < m; X[m] = E[0] - O[0]
            twr, twi = o_r * hw_r - o_i * hw_i, o_r * hw_i + o_i * hw_r
            yr, yi = er + twr, ei + twi
            if first:       # bin 0's imaginary slot carries the real X[m]
                yi[0] = er[0] - twr[0]
            return _apply_scale(yr, yi, scale)

        desc = (f"(plan-distrib-1d-r2c n={n} pack->four-step(m={m}={R}x{C})"
                f" P={p} -> distributed Hermitian untangle; packed"
                f" halfcomplex (m,) out, 5 collectives)")
        plan = _R2CPlan(desc, mesh, dev, vec_l, half_l, local_fn, (m,),
                        dtype, flops, donate, cores)
        plan.packed_layout = True
        return plan

    def local_fn(yr, yi):
        # the packed (m,) half spectrum -> real (n,), times n unnormalized
        xi = yi.clone()
        if first:
            xi[0] = 0.0                         # X[0] is real
        rr, ri = _rev_freq_sharded(yr, 0, ax), _rev_freq_sharded(xi, 0, ax)
        if first:
            rr[0], ri[0] = yi[0], 0.0           # X[m - 0] = X[m] = im(y0)
        # E' = X + conj Xrev; O' = conj(W)^k (X - conj Xrev): the halves
        # cancel against the unnormalized times-n inverse
        er, ei = yr + rr, xi - ri
        dr, di = yr - rr, xi + ri
        o_r, o_i = dr * hw_r - di * hw_i, dr * hw_i + di * hw_r
        zr, zi = fourstep(er - o_i, ei + o_r)               # z' = E' + i O'
        zr, zi = _apply_scale(zr, zi, scale)
        return torch.stack([zr, zi], -1).reshape(-1)        # un-interleave

    desc = (f"(plan-distrib-1d-c2r n={n} distributed Hermitian tangle ->"
            f" inverse four-step(m={m}={R}x{C}) P={p} -> unpack; packed"
            f" halfcomplex (m,) in, 5 collectives)")
    return _C2RPlan(desc, mesh, dev, half_l, vec_l, local_fn, (n,), dtype,
                    flops, donate, cores)


def _pencil_setup(mesh, mesh_shape, axis_names, device):
    """A pencil plan's mesh (``make_pencil_mesh`` of ``mesh_shape``, the
    near-square split of the world when None) and device."""
    def default(dev_type):
        ms = mesh_shape
        if ms is None:
            ms = _default_pencil_shape(_world())
        return make_pencil_mesh(ms, axis_names, device_type=dev_type)
    return _setup(mesh, device, default)


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
    mesh, dev = _pencil_setup(mesh, mesh_shape, axis_names, device)
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


def make_plan_pencil_r2c(shape, norm=Norm.BACKWARD, dtype="complex64",
                         mesh=None,
                         mesh_shape: Optional[Tuple[int, int]] = None,
                         axis_names: Tuple[str, str] = ("fy", "fz"),
                         precision: str = "highest", use_3m: bool = False,
                         max_radix: int = 128, backend: str = "auto",
                         donate: bool = False, device="cuda") -> _R2CPlan:
    """One global real-input 3-D FFT over a 2-D (P1, P2) mesh.  The input
    (Z, Y, X) is split (Z/P1, Y/P2, X); the halved X axis never crosses an
    exchange, all three trade Z pieces for Y pieces:

      r2c(X): (Z/P1, Y/P2, Xh)
      exchange[a1] Y->Z: (Z, Y/(P1 P2), Xh)   fft Z
      exchange[a1] Z->Y: (Z/P1, Y/P2, Xh)
      exchange[a2] Z->Y: (Z/(P1 P2), Y, Xh)   fft Y

    The output is the half spectrum with Z split over both mesh axes
    jointly, ``((a1, a2), None, None)``: rank (c1, c2) holds Z block
    c1 * P2 + c2.  Nyquist-packed at X/2 where ``r2c_packed_supported(X)``
    and Z, Y divide by P1 P2 (the untangle reverses Z over the joint
    axis), else Z and Y padded to P1 P2 blocks.
    Counterpart: ``distributed.py:1419``."""
    norm = Norm(norm)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("pencil r2c is for rank-3 transforms")
    mesh, dev = _pencil_setup(mesh, mesh_shape, axis_names, device)
    a1, a2 = mesh.mesh_dim_names
    ax1, ax2 = _mesh_axis(mesh, a1), _mesh_axis(mesh, a2)
    p1, p2 = ax1.size, ax2.size
    z, y, x = shape
    pp = p1 * p2
    zp, yp = pp * _blk(z, pp), pp * _blk(y, pp)
    uneven = (zp, yp) != (z, y)
    n_total = z * y * x
    scale = _norm_scale(n_total, Direction.FORWARD, norm)
    xh = x // 2 + 1
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, device=dev)
    packed = _sk.r2c_packed_supported(x) and not uneven
    if packed:
        m = x // 2
        joint = _joint_axis(mesh)
        core_z = _LocalCore((z, y // pp, m), (0,), Direction.FORWARD,
                            **core_kw)
        core_y = _LocalCore((z // pp, y, m), (1,), Direction.FORWARD,
                            **core_kw)
        cores = [core_z, core_y]

        def local_fn(v):
            yr, yi = _a2a(*_r2c_rows(v, scale), ax1, 1, 0)  # (Z, Y/PP, m)
            yr, yi = _a2a(*core_z(yr, yi), ax1, 0, 1)       # (Z/P1, Y/P2, m)
            yr, yi = core_y(*_a2a(yr, yi, ax2, 0, 1))       # (Z/PP, Y, m)
            return _untangle_packed(yr, yi, [1], 0, joint)
    else:
        core_r2c = _LocalCore((zp // p1, yp // p2, x), (2,), kind=Kind.R2C,
                              **core_kw)
        core_z = _LocalCore((z, yp // pp, xh), (0,), Direction.FORWARD,
                            **core_kw)
        core_y = _LocalCore((zp // pp, y, xh), (1,), Direction.FORWARD,
                            **core_kw)
        cores = [core_r2c, core_z, core_y]

        def local_fn(v):
            xr, xi = _a2a(*core_r2c(v), ax1, 1, 0)          # (Z, Y/PP, Xh)
            if uneven:    # Z whole: its true length
                xr, xi = _slice_axis(xr, 0, z), _slice_axis(xi, 0, z)
            xr, xi = core_z(xr, xi)
            if uneven:
                xr, xi = _pad_axis(xr, 0, zp), _pad_axis(xi, 0, zp)
            xr, xi = _a2a(xr, xi, ax1, 0, 1)                # (Z/P1, Y/P2, Xh)
            xr, xi = _a2a(xr, xi, ax2, 0, 1)                # (Z/PP, Y, Xh)
            if uneven:    # Y whole: its true length
                xr, xi = _slice_axis(xr, 1, y), _slice_axis(xi, 1, y)
            return _apply_scale(*core_y(xr, xi), scale)

    half = (z, y, xh)
    in_l = _layout(shape, {0: (a1, zp // p1), 1: (a2, yp // p2)})
    out_l = _layout(half, {0: ((a1, a2), zp // pp)})
    desc = (f"(plan-distrib-pencil-r2c real-shape={shape} mesh=({p1}x{p2}) "
            f"r2c(X) -> a2a[{a1}] -> fft(Z) -> a2a[{a1}],a2a[{a2}] -> fft(Y); "
            f"halved axis never crosses a collective"
            f"{'; nyquist-packed transport' if packed else ''}"
            f"{f'; uneven blocks {z}->{zp}|{y}->{yp}' if uneven else ''})")
    flops = 2.5 * n_total * math.log2(max(n_total, 2))
    return _R2CPlan(desc, mesh, dev, in_l, out_l, local_fn, half, dtype,
                    flops, donate, cores)


def make_plan_pencil_c2r(shape, norm=Norm.BACKWARD, dtype="complex64",
                         mesh=None,
                         mesh_shape: Optional[Tuple[int, int]] = None,
                         axis_names: Tuple[str, str] = ("fy", "fz"),
                         precision: str = "highest", use_3m: bool = False,
                         max_radix: int = 128, backend: str = "auto",
                         donate: bool = False, device="cuda") -> _C2RPlan:
    """The inverse of :func:`make_plan_pencil_r2c`: its output layout (Z
    split over both mesh axes) in, the real (Z/P1, Y/P2, X) blocks out;
    ``shape`` is the real shape.  The packed route tangles bin 0 first,
    projecting the endpoint slabs onto their conjugate-even parts over the
    joint axis and Y.  Counterpart: ``distributed.py:1553``."""
    norm = Norm(norm)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("pencil c2r is for rank-3 transforms")
    mesh, dev = _pencil_setup(mesh, mesh_shape, axis_names, device)
    a1, a2 = mesh.mesh_dim_names
    ax1, ax2 = _mesh_axis(mesh, a1), _mesh_axis(mesh, a2)
    p1, p2 = ax1.size, ax2.size
    z, y, x = shape
    pp = p1 * p2
    zp, yp = pp * _blk(z, pp), pp * _blk(y, pp)
    uneven = (zp, yp) != (z, y)
    n_total = z * y * x
    scale = _norm_scale(n_total, Direction.BACKWARD, norm)
    xh = x // 2 + 1
    core_kw = dict(precision=precision, use_3m=use_3m, max_radix=max_radix,
                   backend=backend, device=dev)
    packed = _sk.r2c_packed_supported(x) and not uneven
    if packed:
        m = x // 2
        joint = _joint_axis(mesh)
        core_y = _LocalCore((z // pp, y, m), (1,), Direction.BACKWARD,
                            **core_kw)
        core_z = _LocalCore((z, y // pp, m), (0,), Direction.BACKWARD,
                            **core_kw)
        cores = [core_y, core_z]

        def local_fn(xr, xi):
            xr, xi = core_y(*_tangle_packed(xr, xi, [1], 0, joint))
            xr, xi = _a2a(xr, xi, ax2, 1, 0)                # (Z/P1, Y/P2, m)
            xr, xi = core_z(*_a2a(xr, xi, ax1, 1, 0))       # (Z, Y/PP, m)
            xr, xi = _a2a(xr, xi, ax1, 0, 1)                # (Z/P1, Y/P2, m)
            return _c2r_rows(xr, xi, x, scale)
    else:
        core_c2r = _LocalCore((zp // p1, yp // p2, x), (2,), kind=Kind.C2R,
                              **core_kw)
        core_y = _LocalCore((zp // pp, y, xh), (1,), Direction.BACKWARD,
                            **core_kw)
        core_z = _LocalCore((z, yp // pp, xh), (0,), Direction.BACKWARD,
                            **core_kw)
        cores = [core_c2r, core_y, core_z]

        def local_fn(xr, xi):
            xr, xi = core_y(xr, xi)                         # (Z/PP, Y, Xh)
            if uneven:    # even the a2 split of Y
                xr, xi = _pad_axis(xr, 1, yp), _pad_axis(xi, 1, yp)
            xr, xi = _a2a(xr, xi, ax2, 1, 0)                # (Z/P1, Y/P2, Xh)
            xr, xi = _a2a(xr, xi, ax1, 1, 0)                # (Z, Y/PP, Xh)
            if uneven:    # Z whole: its true length
                xr, xi = _slice_axis(xr, 0, z), _slice_axis(xi, 0, z)
            xr, xi = core_z(xr, xi)
            if uneven:
                xr, xi = _pad_axis(xr, 0, zp), _pad_axis(xi, 0, zp)
            xr, xi = _a2a(xr, xi, ax1, 0, 1)                # (Z/P1, Y/P2, Xh)
            return _scaled(core_c2r(xr, xi), scale)

    half = (z, y, xh)
    in_l = _layout(half, {0: ((a1, a2), zp // pp)})
    out_l = _layout(shape, {0: (a1, zp // p1), 1: (a2, yp // p2)})
    desc = (f"(plan-distrib-pencil-c2r real-shape={shape} mesh=({p1}x{p2}) "
            f"ifft(Y) -> a2a[{a2}],a2a[{a1}] -> ifft(Z) -> a2a[{a1}] -> c2r(X)"
            f"{' [nyquist-packed transport]' if packed else ''}"
            f"{f' [uneven blocks {z}->{zp}|{y}->{yp}]' if uneven else ''})")
    flops = 2.5 * n_total * math.log2(max(n_total, 2))
    return _C2RPlan(desc, mesh, dev, in_l, out_l, local_fn, shape, dtype,
                    flops, donate, cores)


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
    """Build the distributed plan a strategy dict describes (collective:
    every rank calls it alike); the plan's ``strategy`` is that dict.
    ``n_devices``, if given, must be the world size.  ``kind=R2C``/``C2R``
    build the real slab, pencil or rank-1 plans (``direction`` is the
    kind's; the chunk counts are C2C knobs and are dropped).
    Counterpart: ``distributed.py:1786``."""
    s = dict(strategy)
    mode = s.pop("mode")
    kind = Kind(kw.pop("kind", Kind.C2C))
    if n_devices is not None and int(n_devices) != _world():
        raise ValueError(f"n_devices={n_devices}: a distributed plan spans "
                         f"the world of {_world()} ranks")
    real = kind in (Kind.R2C, Kind.C2R)
    if mode == "shards":
        s.pop("pipeline_chunks", None)
        plan = make_plan_shards(shape, kind=kind, direction=direction,
                                norm=norm, **kw)
    elif real and mode == "slab1d":
        plan = make_plan_slab_1d(shape[0], norm=norm, kind=kind, **s, **kw)
    elif real:
        s.pop("pipeline_chunks", None)
        s.pop("pipeline_chunks2", None)
        ctor = {("slab", Kind.R2C): make_plan_slab_r2c,
                ("slab", Kind.C2R): make_plan_slab_c2r,
                ("pencil", Kind.R2C): make_plan_pencil_r2c,
                ("pencil", Kind.C2R): make_plan_pencil_c2r}.get((mode, kind))
        if ctor is None:
            raise ValueError(f"no {kind} constructor for mode {mode!r}")
        if mode == "pencil":
            ms = s.pop("mesh_shape", None)
            kw = dict(kw, mesh_shape=None if ms is None else tuple(ms))
            kw.pop("mesh", None)
        plan = ctor(shape, norm=norm, **s, **kw)
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
    {name: seconds} in its ``measurements``.  ``kind=R2C``/``C2R`` choose
    among the real slab and pencil plans (rank 3) or the rank-1 real plan;
    their padded volume counts axes 0 and 1 (the axes they exchange).
    Counterpart: ``distributed.py:1841``."""
    kind, direction, norm = Kind(kind), Direction(direction), Norm(norm)
    shape = tuple(shape)
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
        # the padded share of the volume the exchanges move: slab over
        # axes 0 and -1 (0 and 1 for the real kinds), pencil over Z, Y, X
        # (Z and Y, in P1 P2 blocks, for the real kinds)
        if c["mode"] == "slab":
            a = shape[-1] if kind == Kind.C2C else shape[1]
            return (p * _blk(shape[0], p) * p * _blk(a, p)
                    / (shape[0] * a) - 1.0)
        if c["mode"] == "pencil":
            q1, q2 = c["mesh_shape"]
            if kind == Kind.C2C:
                z, y, x = shape
                lcm12 = q1 * q2 // math.gcd(q1, q2)
                return (q1 * _blk(z, q1) * lcm12 * _blk(y, lcm12)
                        * q2 * _blk(x, q2)) / (z * y * x) - 1.0
            pp = q1 * q2
            return (pp * _blk(shape[0], pp) * pp * _blk(shape[1], pp)
                    / (shape[0] * shape[1]) - 1.0)
        return 0.0

    def rank_key(c):
        rounds = {"slab": 0, "slab1d": 0}.get(c["mode"], 1)
        return (pad_overhead(c) + 0.10 * rounds,
                c.get("pipeline_chunks", 1) != 1)
    return build_strategy(min(cands, key=rank_key), shape, direction, norm,
                          n_devices=p, kind=kind, **kw)
