"""Process groups and device meshes over ``torch.distributed``.

Counterpart: ``regent_fft_tpu/parallel/mesh.py``.  The JAX package builds
``jax.sharding.Mesh`` objects over the devices one controller sees; here
every rank is a process holding one device (one card, or the host for a
CPU plan), and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the world, one process group per mesh axis.  A CUDA
mesh needs an NCCL world, a CPU mesh a gloo world (:func:`init_distributed`
picks the backend from the device).

Building a mesh is collective: every rank calls the same function with the
same arguments, in the same order.  Meshes are kept per (device type,
shape, axis names, ranks), so planning the same layout again creates no
new process group.
"""
from __future__ import annotations

import os
import socket
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_MESHES: dict = {}


def _backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device_type!r}")


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join (or start) the process group: NCCL for ``device="cuda"``, gloo
    for ``device="cpu"``.

    With no arguments the ``torchrun`` environment (``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) is read (``env://``); else
    pass ``init_method`` (``"tcp://host:port"`` or ``"file://path"``),
    ``world_size`` and ``rank``.  A CUDA call first selects the rank's card,
    ``torch.cuda.set_device(LOCAL_RANK)`` (the rank modulo the local card
    count when ``LOCAL_RANK`` is unset); no card raises.  Idempotent: once
    a group exists, a call returns at once.  Ends with
    :func:`~regent_fft_tpu_torch.utils.plog.dump_machine_model`.
    Counterpart: ``regent_fft_tpu/parallel/mesh.py:37``
    (``jax.distributed.initialize``).
    """
    if dist.is_initialized():
        return
    dev = torch.device(device).type
    backend = _backend_for(dev)
    kwargs = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                               "device; pass device='cpu' for a gloo group")
        local = os.environ.get("LOCAL_RANK")
        r = int(rank if rank is not None else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) if local is not None
                              else r % torch.cuda.device_count())
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kwargs)
    from ..utils.plog import dump_machine_model
    dump_machine_model()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first "
                           "(every rank, before planning)")
    return dist.get_world_size()


def num_nodes() -> int:
    """The reference's node-count tunable (src/fft.rg:146-148): the world
    size, or 1 outside a process group, as
    ``FFTInterface.get_num_nodes``.  Counterpart: ``mesh.py:73``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def num_local_devices() -> int:
    """The reference's local-GPU tunable (src/fft.rg:151-153): the CUDA
    devices of this host.  Counterpart: ``mesh.py:78``."""
    return torch.cuda.device_count()


def check_backend(group, device_type: str) -> None:
    """Raise unless ``group`` exchanges tensors of ``device_type``: NCCL
    for CUDA, gloo for the CPU.  A CUDA plan never stages an exchange
    through the host."""
    backend = str(dist.get_backend(group)).lower()
    want = _backend_for(device_type)
    if want not in backend:
        raise RuntimeError(
            f"a {device_type} plan needs a {want.upper()} group, and this "
            f"group's backend is {backend!r}: call init_distributed("
            f"device={device_type!r}) on every rank")


def _device_mesh(device_type: str, ranks: np.ndarray, names):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    world = _world()
    check_backend(None, device_type)
    names = tuple(names)
    key = (device_type, tuple(ranks.shape), names,
           tuple(int(r) for r in ranks.reshape(-1)))
    mesh = _MESHES.get(key)
    if mesh is None:
        if ranks.size == world and np.array_equal(ranks.reshape(-1),
                                                  np.arange(world)):
            mesh = init_device_mesh(device_type, tuple(ranks.shape),
                                    mesh_dim_names=names)
        else:
            mesh = DeviceMesh(device_type, torch.as_tensor(ranks),
                              mesh_dim_names=names)
        _MESHES[key] = mesh
    return mesh


def make_fft_mesh(n_devices: Optional[int] = None, axis_name: str = "fft",
                  device_type: str = "cuda"):
    """1-D mesh over the world's ranks for slab, per-shard and rank-1 plans.

    ``n_devices`` must be the world size (every rank holds a block).
    Counterpart: ``mesh.py:18``."""
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh spans the world: n_devices={n}, world "
                         f"size {world}")
    return _device_mesh(device_type, np.arange(n), (axis_name,))


def make_pencil_mesh(shape: Tuple[int, int],
                     axis_names: Tuple[str, str] = ("fy", "fz"),
                     device_type: str = "cuda"):
    """2-D (rows x cols) mesh for pencil plans, ranks row-major: rank
    ``i * cols + j`` sits at (i, j).  Counterpart: ``mesh.py:26``."""
    world = _world()
    p1, p2 = int(shape[0]), int(shape[1])
    if p1 * p2 != world:
        raise ValueError(f"need {p1 * p2} ranks for a {p1}x{p2} mesh, the "
                         f"world has {world}")
    return _device_mesh(device_type, np.arange(world).reshape(p1, p2),
                        axis_names)


class RankDevice(NamedTuple):
    """A rank as ``_select_multislice`` sees it: ``slice_index`` is the
    index of its host (by first appearance in rank order)."""

    rank: int
    slice_index: int


def make_multislice_mesh(dcn: int, ici: Optional[int] = None,
                         axis_names: Tuple[str, str] = ("slice", "chip"),
                         device_type: str = "cuda"):
    """2-D mesh whose first axis crosses hosts and whose second stays
    within one: each mesh row is drawn from one host's ranks, so a pencil
    plan over it pays one collective across the network (the second
    exchange) and one within a host.  On one host the ranks are reshaped
    row-major with the same axis meaning.  The JAX package groups by
    ``device.slice_index`` (TPU slices over DCN); here the host name,
    gathered from every rank, takes its place.
    Counterpart: ``mesh.py:83``."""
    world = _world()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    index = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
    devices = [RankDevice(r, index[h]) for r, h in enumerate(hosts)]
    arr = _select_multislice(devices, dcn, ici)
    ranks = np.vectorize(lambda d: d.rank, otypes=[np.int64])(arr)
    if ranks.size != world:
        raise ValueError(f"a mesh spans the world: {ranks.shape} over "
                         f"{world} ranks")
    return _device_mesh(device_type, ranks, axis_names)


def _select_multislice(devices, dcn: int, ici: Optional[int]) -> np.ndarray:
    """Pick a (dcn, ici) array of ``devices`` with one slice (host) per
    row, grouping by ``slice_index`` so a partial selection still spans
    ``dcn`` slices.  Pure logic, testable without a cluster.
    Counterpart: ``mesh.py:106``."""
    dcn = int(dcn)
    if dcn < 1:
        raise ValueError(f"need at least one slice, got dcn={dcn}")
    if ici is None:
        ici = len(devices) // dcn
    ici = int(ici)
    need = dcn * ici
    if ici < 1 or len(devices) < need:
        raise ValueError(
            f"need {dcn}x{max(ici, 1)} devices, have {len(devices)}")
    by_slice = {}
    for d in devices:
        by_slice.setdefault(getattr(d, "slice_index", 0), []).append(d)
    if len(by_slice) > 1:
        groups = [g for g in by_slice.values() if len(g) >= ici]
        if len(groups) < dcn:
            raise ValueError(
                f"need {dcn} slices with >= {ici} devices each; have "
                f"{ {k: len(v) for k, v in by_slice.items()} }")
        out = np.empty((dcn, ici), dtype=object)
        for i, g in enumerate(groups[:dcn]):
            for j in range(ici):
                out[i, j] = g[j]
        return out
    out = np.empty((dcn, ici), dtype=object)
    for k in range(need):
        out[k // ici, k % ici] = devices[k]
    return out
