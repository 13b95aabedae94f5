"""A pool of ``torch.distributed`` ranks on the host for the port's
distributed tests (gloo, one thread a rank).

Not a test module (pytest collects ``test_*.py`` only).  It imports numpy,
torch and the port, never JAX and never a test module, because every
spawned rank imports it to find its tasks.  A test file starts one pool per
world size (a module-scoped fixture); each rank joins the group through the
port's own ``init_distributed(device="cpu", init_method="file://...")`` and
then serves tasks from its queue: a function of this module, run on every
rank at once, whose return value comes back to the test in rank order.
Every result has a timeout; on a timeout the pool is killed and the task
raises ``PoolError``, so a hung collective fails one test and never stalls
the suite, and the next task starts a fresh pool.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np

TIMEOUT = 60.0


class PoolError(RuntimeError):
    pass


def _serve(rank, world, init_file, tasks, results):
    try:
        import torch
        torch.set_num_threads(1)
        from regent_fft_tpu_torch.parallel.mesh import init_distributed
        init_distributed(device="cpu", init_method="file://" + init_file,
                         world_size=world, rank=rank)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args, kwargs = task
        try:
            results.put((rank, True, globals()[name](*args, **kwargs)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks serving this module's task functions."""

    def __init__(self, world: int, timeout: float = TIMEOUT):
        self.world, self.timeout = world, timeout
        self._procs = []
        self._start()

    def _start(self):
        ctx = mp.get_context("spawn")
        fd, self._file = tempfile.mkstemp(prefix="torch_dist_pool_")
        os.close(fd)
        os.unlink(self._file)
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(r, self.world, self._file,
                                         self._tasks[r], self._results))
                       for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what):
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self._results.get(timeout=self.timeout)
            except queue.Empty:
                self.kill()
                raise PoolError(f"{what}: a rank gave no result in "
                                f"{self.timeout} s; pool killed") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise PoolError(f"{what} failed\n" + "\n".join(errors))
        return out

    def run(self, name: str, *args, **kwargs) -> list:
        """Run task ``name`` with these arguments on every rank; its
        results in rank order."""
        if not self.alive():
            self.kill()
            self._start()
        for q in self._tasks:
            q.put((name, args, kwargs))
        return self._collect(name)

    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def kill(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []
        if os.path.exists(self._file):
            os.unlink(self._file)

    def close(self):
        if self.alive():
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=10)
        self.kill()


# ---------------------------------------------------------------------------
# Tasks (run on every rank)
# ---------------------------------------------------------------------------

def _np(y):
    """A plan's output as numpy: complex for split planes and complex
    tensors, else the array."""
    import torch
    from regent_fft_tpu_torch.dtypes import SplitComplex
    if isinstance(y, SplitComplex):
        return (y.re.float().numpy() + 1j * y.im.float().numpy()
                ).astype(np.complex64)
    if isinstance(y, torch.Tensor):
        return y.numpy()
    return np.asarray(y)


def _mesh(spec):
    """A mesh from its spec: ("fft" | "pencil" | "multislice", args...),
    or ("ranks", nested rank lists, axis names) for any order of ranks."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from regent_fft_tpu_torch.parallel import mesh as M
    if spec is None:
        return None
    kind, *args = spec
    if kind == "ranks":
        return DeviceMesh("cpu", torch.as_tensor(args[0]),
                          mesh_dim_names=tuple(args[1]))
    fn = {"fft": M.make_fft_mesh, "pencil": M.make_pencil_mesh,
          "multislice": M.make_multislice_mesh}[kind]
    return fn(*args, device_type="cpu")


def _ctor(name):
    from regent_fft_tpu_torch import api
    from regent_fft_tpu_torch.parallel import distributed as D
    from regent_fft_tpu_torch.parallel import transpose as T
    if name == "interface":
        def make(iface, shape, **kw):
            return api.generate_fft_interface(*iface, device="cpu"
                                              ).make_plan_distrib(shape, **kw)
        return make
    if name == "build_strategy":
        return D.build_strategy
    if name == "make_plan_slab_r2r":
        from regent_fft_tpu_torch.parallel import distributed_r2r as DR
        return DR.make_plan_slab_r2r
    return getattr(D, name, None) or getattr(T, name)


def _build(name, args, kw):
    kw = dict(kw)
    if name != "interface":
        kw.setdefault("device", "cpu")
    if "mesh" in kw:
        kw["mesh"] = _mesh(kw["mesh"])
    return _ctor(name)(*args, **kw)


def plan_chain(stages, x):
    """Build each (constructor, args, kwargs) stage's plan; run the first
    on this rank's block of the global ``x`` and each later one on the
    previous stage's local output.  Per stage: the local output, this
    rank's blocks, every rank's blocks, and the plan's fields."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    y = None
    for k, (name, args, kw) in enumerate(stages):
        plan = _build(name, args, kw)
        y = plan(x[plan.in_block(rank)] if k == 0 else y)
        out.append({
            "y": _np(y), "out_block": plan.out_block(rank),
            "in_blocks": [plan.in_block(r) for r in range(world)],
            "out_blocks": [plan.out_block(r) for r in range(world)],
            "local_in_shape": plan.local_in_shape,
            "local_out_shape": plan.local_out_shape,
            "in_spec": plan.in_spec, "out_spec": plan.out_spec,
            "out_shape": plan.out_shape,
            "global_shape": plan.global_shape,
            "description": plan.description,
            "dtype": str(getattr(y, "dtype", None))})
    return out


def plan_error(name, args, kw):
    """(exception type, message) of building a plan, or None."""
    try:
        _build(name, args, kw)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def call_error(name, args, kw, x):
    """(exception type, message) of calling a built plan on ``x``."""
    plan = _build(name, args, kw)
    try:
        plan(x)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def destroyed_call(name, args, kw, x):
    """(exception type, message) of calling a plan after destroy."""
    import torch.distributed as dist
    plan = _build(name, args, kw)
    plan(x[plan.in_block(dist.get_rank())])
    if name == "interface":
        from regent_fft_tpu_torch.parallel.distributed import \
            destroy_plan_distrib
        destroy_plan_distrib(plan)
    else:
        plan.destroy()
    try:
        plan(x[plan.in_block(dist.get_rank())])
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def exchange(shape, split, concat, mesh=None, axis=None):
    """This rank's block (values encode (rank, flat index)) through the
    plans' exchange over ``axis`` of ``mesh``; returns the block and the
    result."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from regent_fft_tpu_torch.parallel import distributed as D
    from regent_fft_tpu_torch.parallel import mesh as M
    rank = dist.get_rank()
    if mesh is None:
        m = M.make_fft_mesh(device_type="cpu")
    else:
        m = DeviceMesh("cpu", torch.as_tensor(mesh), mesh_dim_names=axis)
    ax = D._mesh_axis(m, m.mesh_dim_names[-1])
    n = int(np.prod(shape))
    xr = torch.arange(n, dtype=torch.float64).reshape(shape) + 1000 * rank
    xi = -xr
    yr, yi = D._a2a(xr, xi, ax, split, concat)
    return {"x": xr.numpy(), "y": yr.numpy(), "yi": yi.numpy(),
            "coord": ax.coord, "perm": ax.perm,
            "line": [int(v) for v in m.mesh.reshape(-1)]}


def exchange_dtypes(shape, dtype):
    """Run a slab plan of ``dtype`` with every collective's buffer dtype
    recorded; returns the dtypes and the output."""
    import torch.distributed as dist
    from regent_fft_tpu_torch.parallel import distributed as D
    seen = []
    real = dist.all_to_all_single

    def spy(out, inp, *a, **k):
        seen.append(str(inp.dtype))
        return real(out, inp, *a, **k)
    plan = D.make_plan_slab(shape, norm=D.Norm.NONE, dtype=dtype,
                            device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    dist.all_to_all_single = spy
    try:
        y = plan(x[plan.in_block(dist.get_rank())].astype(np.complex64))
    finally:
        dist.all_to_all_single = real
    return {"dtypes": seen, "y": _np(y), "out_block":
            plan.out_block(dist.get_rank()), "plane_dtype":
            str(plan.plane_dtype())}


def logged_chain(stages, x):
    """``plan_chain`` with the port's log records kept at level 2: the
    per-rank results and the records."""
    import logging
    from regent_fft_tpu_torch.utils import plog
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    h = Keep()
    plog.logger.addHandler(h)
    plog.set_log_level(2)
    try:
        out = plan_chain(stages, x)
    finally:
        plog.set_log_level(0)
        plog.logger.removeHandler(h)
    return {"results": out, "records": records}


def a2a_buffers(stages, x):
    """``plan_chain`` with the (dtype, shape) of every buffer a collective
    sends recorded: the buffers and the results."""
    import torch.distributed as dist
    seen = []
    real = dist.all_to_all_single

    def spy(out, inp, *a, **k):
        seen.append((str(inp.dtype), list(inp.shape)))
        return real(out, inp, *a, **k)
    dist.all_to_all_single = spy
    try:
        out = plan_chain(stages, x)
    finally:
        dist.all_to_all_single = real
    return {"buffers": seen, "results": out}


def c2r_input_kept(shape, y):
    """A packed slab C2R plan run on planes of this rank's block: whether
    the planes are unchanged after the call, and the output."""
    import torch
    import torch.distributed as dist
    from regent_fft_tpu_torch.parallel import distributed as D
    plan = D.make_plan_slab_c2r(shape, norm=D.Norm.NONE, device="cpu")
    blk = y[plan.in_block(dist.get_rank())]
    re = torch.from_numpy(np.ascontiguousarray(blk.real, np.float32))
    im = torch.from_numpy(np.ascontiguousarray(blk.imag, np.float32))
    keep = (re.clone(), im.clone())
    out = plan.execute_split(re, im)
    return {"kept": torch.equal(re, keep[0]) and torch.equal(im, keep[1]),
            "y": out.numpy(), "out_block": plan.out_block(dist.get_rank())}


def joint_reversal(ranks, names, block):
    """The modular frequency reversal over the joint axis of a mesh (rank
    lists in any order): each rank holds ``block`` values of a global
    vector indexed by its row-major mesh position; returns its position
    and the reversed block."""
    import torch
    import torch.distributed as dist
    from regent_fft_tpu_torch.parallel import distributed as D
    mesh = _mesh(("ranks", ranks, names))
    ax = D._joint_axis(mesh)
    q = D._coords(mesh, dist.get_rank())[tuple(names)]
    x = torch.arange(q * block, (q + 1) * block, dtype=torch.float64)
    y = D._rev_freq_sharded(x.reshape(block, 1).repeat(1, 3), 0, ax)
    return {"coord": q, "ax_coord": ax.coord, "perm": ax.perm,
            "y": y[:, 0].numpy(), "cols_equal": bool((y == y[:, :1]).all())}


def race(shape, times, chunk_candidates=(1, 2, 4), kind=None):
    """``measure_distributed`` of ``kind`` (C2C by default) with each
    rank's time of a strategy ``times[name][rank]`` (seconds); returns the
    winner, the timings, the plan ``make_plan_distributed`` then gives in
    estimate mode (the installed winner), and the exported "distrib"
    wisdom."""
    import json
    import torch.distributed as dist
    from regent_fft_tpu_torch.parallel import distributed as D
    from regent_fft_tpu_torch.utils import measure, wisdom
    rank = dist.get_rank()
    real = measure.time_distributed
    measure.time_distributed = lambda plan, reps=3, seed=0: \
        times[D.strategy_name(plan.strategy)][rank]
    kind = D.Kind.C2C if kind is None else kind
    D._DISTRIB_WISDOM.clear()
    try:
        winner, timings = measure.measure_distributed(
            shape, norm=D.Norm.NONE, chunk_candidates=chunk_candidates,
            kind=kind, device="cpu")
    finally:
        measure.time_distributed = real
    plan = D.make_plan_distributed(shape, norm=D.Norm.NONE, kind=kind,
                                   device="cpu")
    exported = json.loads(wisdom.export_wisdom_to_string())["distrib"]
    D._DISTRIB_WISDOM.clear()
    return {"winner": winner, "timings": timings,
            "strategy": plan.strategy, "description": plan.description,
            "distrib": exported}


def measured_plan(shape, x, kind=None):
    """``make_plan_distributed(planner="measure")`` of ``kind`` (C2C by
    default) on the real timer: the winner must agree on every rank;
    returns it and the output."""
    import torch.distributed as dist
    from regent_fft_tpu_torch.parallel import distributed as D
    D._DISTRIB_WISDOM.clear()
    plan = D.make_plan_distributed(shape, norm=D.Norm.NONE, planner="measure",
                                   chunk_candidates=(1, 2), device="cpu",
                                   kind=D.Kind.C2C if kind is None else kind)
    y = plan(x[plan.in_block(dist.get_rank())])
    D._DISTRIB_WISDOM.clear()
    return {"strategy": plan.strategy, "y": _np(y),
            "measurements": plan.measurements,
            "out_block": plan.out_block(dist.get_rank()),
            "out_shape": plan.out_shape}


def wisdom_sync(entries):
    """Each rank records ``entries[rank]`` (strategy dicts keyed by shape),
    then gather_wisdom and broadcast_wisdom; returns each step's count and
    the distributed table after each."""
    import torch.distributed as dist
    from regent_fft_tpu_torch.parallel import distributed as D
    from regent_fft_tpu_torch.utils import wisdom
    rank = dist.get_rank()
    wisdom.forget_wisdom()
    for shape, strat in entries[rank]:
        D._DISTRIB_WISDOM[D._distrib_key(shape, dist.get_world_size(),
                                         D.Direction.FORWARD,
                                         D.Norm.BACKWARD)] = strat
    n_gather = wisdom.gather_wisdom()
    after_gather = dict(D._DISTRIB_WISDOM)
    n_bcast = wisdom.broadcast_wisdom()
    after_bcast = dict(D._DISTRIB_WISDOM)
    wisdom.forget_wisdom()
    return {"gather": n_gather, "broadcast": n_bcast,
            "after_gather": after_gather, "after_broadcast": after_bcast}


def multislice(dcn, ici=None):
    """The mesh make_multislice_mesh gives, or its error."""
    from regent_fft_tpu_torch.parallel import mesh as M
    try:
        m = M.make_multislice_mesh(dcn, ici, device_type="cpu")
    except ValueError as e:
        return ("ValueError", str(e))
    return {"names": m.mesh_dim_names, "shape": tuple(m.mesh.shape),
            "ranks": m.mesh.tolist()}


def world_facts():
    """num_nodes, the interface's node count and the machine model."""
    from regent_fft_tpu_torch import api
    from regent_fft_tpu_torch.parallel import mesh as M
    from regent_fft_tpu_torch.utils.plog import dump_machine_model
    M.init_distributed(device="cpu")      # a second call: returns at once
    return {"num_nodes": M.num_nodes(),
            "iface_nodes": api.FFTInterface.get_num_nodes(),
            "num_local_devices": M.num_local_devices(),
            "iface_local": api.FFTInterface.get_num_local_devices(),
            "model": dump_machine_model()}


def donate_check(shape, donate):
    """A slab plan run on SplitComplex f32 planes of this rank's block:
    whether the caller's planes were overwritten, and the output."""
    import torch
    import torch.distributed as dist
    from regent_fft_tpu_torch.dtypes import SplitComplex
    from regent_fft_tpu_torch.parallel import distributed as D
    plan = D.make_plan_slab(shape, norm=D.Norm.NONE, donate=donate,
                            device="cpu")
    g = np.random.default_rng(0)
    x = g.standard_normal(shape) + 1j * g.standard_normal(shape)
    blk = x[plan.in_block(dist.get_rank())]
    re = torch.from_numpy(np.ascontiguousarray(blk.real, np.float32))
    im = torch.from_numpy(np.ascontiguousarray(blk.imag, np.float32))
    keep = re.clone()
    y = plan(SplitComplex(re, im))
    return {"overwritten": not torch.equal(re, keep), "y": _np(y),
            "out_block": plan.out_block(dist.get_rank())}
