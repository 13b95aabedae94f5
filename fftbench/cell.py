"""One rank of one cell: plans, fields, warm-up, the window, the check.

Imported by ``run.py`` after it has fixed the program's environment;
the port (``regent_fft_tpu_torch``) is imported inside the functions
here, never at import time.  A rank holds one card (or the host, for the
plain versions in a test); a cell on several cards runs one rank a card,
joined by the port's ``init_distributed``.

The window is a closed loop with one caller: step i runs the forward
plan on field ``i % fields`` and the backward plan on its output, and
the caller waits on the CUDA event of step i - ``inflight`` before it
issues step i.  The step count is fixed before the window from the
step time of a short probe paced as the window is, so the window lasts
about ``--seconds`` and every rank issues the same steps.  The outputs
of one step drawn from the seed and of the last step are kept and judged
once the window has closed and the program's state is freed.
"""
from __future__ import annotations

import importlib
import math
import sys
import time
import traceback

import torch

from . import devtrace, reference, traffic, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "regent_fft_tpu")
CONTROL_DTYPE = "complex32"   # the program's own lower-precision path
PROBE_STEPS = 4
PROBE_S = 0.25       # the paced probe that sets the window's step count


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load: JAX and the JAX package (whole names: the port's name begins
    with the JAX package's)."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


class _HostMark:
    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def _mark(dev):
    if dev.type != "cuda":
        return _HostMark()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_plans(cfg: dict, dev, control: bool):
    """The forward and backward plans of ``cfg`` through the port's
    entries, their plane dtype, their describe() lines and switches."""
    import regent_fft_tpu_torch as rt
    from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm
    dtype = CONTROL_DTYPE if control else cfg["dtype"]
    shape, norm = tuple(cfg["shape"]), Norm(cfg["norm"])
    if cfg["decomposition"] == "slab":
        from regent_fft_tpu_torch.parallel import distributed as dd
        if cfg["kind"] != "c2c":
            raise ValueError("the slab cells run C2C plans")
        kw = dict(norm=norm, dtype=dtype, backend=cfg["backend"],
                  device=str(dev))
        fwd = dd.make_plan_slab(shape, Direction.FORWARD,
                                transposed_out=True, **kw)
        bwd = dd.make_plan_slab(shape, Direction.BACKWARD,
                                transposed_in=True, **kw)
        lines = [fwd.description, bwd.description] + [
            p.describe() for p in fwd.cores + bwd.cores]
        return fwd, bwd, fwd.plane_dtype(), lines, fwd.cores[0].switches
    fwd = rt.make_plan(shape, axes=tuple(cfg["axes"]), kind=Kind(cfg["kind"]),
                       direction=Direction.FORWARD, norm=norm, dtype=dtype,
                       planner=cfg["planner"], backend=cfg["backend"],
                       device=str(dev))
    bwd = fwd.inverse()
    return fwd, bwd, fwd.cdtype, [fwd.describe(), bwd.describe()], \
        fwd.switches


def plan_calls(fwd, bwd, cfg: dict, interface: str):
    """The step's two calls into the port for the cell's interface."""
    if interface == "complex":
        return fwd, bwd
    if cfg["kind"] == "r2c":
        return (lambda x: fwd.execute_real(x[0])), \
            (lambda y: bwd.execute_split(*y))
    return (lambda x: fwd.execute_split(*x)), \
        (lambda y: bwd.execute_split(*y))


def free_program(fwd, bwd):
    """Drop the plans and the port's caches, so the reference runs on a
    card that holds no program state."""
    import regent_fft_tpu_torch as rt
    for p in (fwd, bwd):
        if hasattr(p, "destroy"):
            p.destroy()
    rt.clear_plan_cache()


def _blocks(plan, rank: int, ndim: int):
    """The rank's (rows of axis 0, columns of the last axis) of a
    distributed plan's input and output, or whole for one card."""
    if not hasattr(plan, "in_block"):
        return slice(None), slice(None)
    rows, cols = plan.in_block(rank)[0], plan.out_block(rank)[ndim - 1]
    return rows, cols


def window(calls, fields, n_steps: int, inflight: int, dev, traced: bool,
           keep: set):
    """Run the window: returns (step ms, host enqueue s, wall s, wall
    start, kept {step: (forward out, backward out)})."""
    fwd_call, bwd_call = calls
    marks = [None] * (n_steps + 1)
    kept, enq = {}, 0.0
    _sync(dev)
    with devtrace.span(devtrace.WINDOW, traced):
        start_wall = time.time()
        t0 = time.perf_counter()
        marks[0] = _mark(dev)
        for i in range(n_steps):
            if i >= inflight:
                with devtrace.span("wait", traced):
                    marks[i - inflight + 1].synchronize()
            x = fields[i % len(fields)]
            a = time.perf_counter()
            with devtrace.span("enqueue.fwd", traced):
                y = fwd_call(x)
            with devtrace.span("enqueue.bwd", traced):
                z = bwd_call(y)
            enq += time.perf_counter() - a
            marks[i + 1] = _mark(dev)
            if i in keep or i == n_steps - 1:
                kept[i] = (y, z)
            del x, y, z
        _sync(dev)
        wall = time.perf_counter() - t0
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n_steps)]
    return step_ms, enq, wall, start_wall, kept


def _agree_min(n: int, dev, world: int) -> int:
    if world == 1:
        return n
    import torch.distributed as dist
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _barrier(world: int):
    if world > 1:
        import torch.distributed as dist
        dist.barrier()


def check(kept: dict, cfg: dict, workload: dict, seed: int, rank: int,
          world: int, cols, dev) -> tuple:
    """The compared numbers, the worst over the kept steps, and the
    count of kept transforms with a number over its limit."""
    def block(field):
        return lambda b: traffic.field_block(cfg, seed, field, b, world, dev)
    worst, failed, refs = {}, 0, {}
    for i in sorted(kept):
        y, z = kept.pop(i)
        f = i % int(workload["fields"])
        if f not in refs:
            refs.clear()
            refs[f] = reference.forward_reference(block(f), world,
                                                  cfg["kind"], cols)
        for tag, out, ref in (("fwd", y, refs[f]), ("bwd", z, None)):
            if ref is None:
                ref = reference.as_complex128(block(f)(rank))
            nums = reference.compare(out, ref)
            del ref
            bad = False
            for k, v in nums.items():
                name = f"{tag}_{k}"
                worst[name] = max(worst.get(name, 0.0), v)
                lim = workload["limits"].get(name)
                bad |= lim is not None and not v <= lim
            failed += bad
        del y, z
    return worst, failed


def run_rank(task: dict) -> list:
    """Everything one rank does for a cell: one record per seed."""
    rank, world = task["rank"], task["world"]
    cfg, wl = task["config"], task["workload"]
    traffic.check_workload(wl)
    cuda = task["device"] == "cuda"
    if world > 1:
        from regent_fft_tpu_torch.parallel.mesh import init_distributed
        init_distributed(device=task["device"],
                         init_method=task["init_method"],
                         world_size=world, rank=rank)
    elif cuda:
        torch.cuda.set_device(0)
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    if task.get("patch"):
        mod, fn = task["patch"].split(":")
        getattr(importlib.import_module(mod), fn)()
    phases = [("start", task["t0"]), ("start-up", time.time())]
    if cuda:
        from regent_fft_tpu_torch.ops import _build
        if rank == 0:
            _build.load()
        _barrier(world)
        _build.load()
    phases.append(("kernel library", time.time()))
    from regent_fft_tpu_torch.ops import stockham_kernels as sk
    fwd, bwd, plane_dtype, lines, switches = make_plans(
        cfg, dev, task.get("control", False))
    phases.append(("plans", time.time()))
    if rank == 0:
        for line in lines:
            print(line, file=sys.stderr)
        print(f"switches: {switches}", file=sys.stderr)
    rows, cols = _blocks(fwd, rank, len(cfg["shape"]))
    want = traffic.block_rows(cfg["shape"], world, rank)
    if rows != slice(None) and (rows.start, rows.stop) != (want.start,
                                                           want.stop):
        raise RuntimeError(f"rank {rank} holds rows {rows}, the traffic "
                           f"makes {want}")
    calls = plan_calls(fwd, bwd, cfg, wl["interface"])
    inflight, nf = int(wl["inflight"]), int(wl["fields"])
    kind = cfg["kind"]
    flops = 2 * yardstick.transform_flops(cfg["shape"], cfg["axes"],
                                          kind != "c2c")
    nbytes = (yardstick.transform_bytes(cfg["shape"], cfg["axes"], kind,
                                        cfg["dtype"])
              + yardstick.transform_bytes(
                  cfg["shape"], cfg["axes"],
                  {"c2c": "c2c", "r2c": "c2r"}[kind], cfg["dtype"]))
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    out = []
    for seed in task["seeds"]:
        fields = [traffic.as_interface(
            traffic.field_block(cfg, seed, f, rank, world, dev),
            wl["interface"], plane_dtype) for f in range(nf)]
        _sync(dev)
        phases.append(("fields", time.time()))
        for i in range(2 * nf):               # warm-up: the cell's shapes
            calls[1](calls[0](fields[i % nf]))
        _sync(dev)
        phases.append(("warm-up", time.time()))
        t = time.perf_counter()
        for i in range(PROBE_STEPS):
            calls[1](calls[0](fields[i % nf]))
        _sync(dev)
        step_s = (time.perf_counter() - t) / PROBE_STEPS
        n = _agree_min(max(PROBE_STEPS,
                           math.ceil(PROBE_S / max(step_s, 1e-6))), dev, world)
        step_s = window(calls, fields, n, inflight, dev, False, set())[2] / n
        n_steps = _agree_min(
            max(2 * traffic.SAMPLE_WINDOW,
                round(task["seconds"] / max(step_s, 1e-6))), dev, world)
        keep = {traffic.sample_step(seed, n_steps)}
        if rank == 0:
            print("set-up s: " + ", ".join(
                f"{name} {b - a:.3f}" for (_, a), (name, b)
                in zip(phases, phases[1:])) + f"; {n_steps} steps of "
                f"{1e3 * step_s:.3f} ms probed", file=sys.stderr)
        phases = phases[-1:]
        sk.reset_launches()
        prof = None
        if task["trace"]:
            prof = devtrace.profiler(dev)
            prof.__enter__()
        try:
            _barrier(world)     # every rank's window starts together
            step_ms, enq, wall, start_wall, kept = window(
                calls, fields, n_steps, inflight, dev, bool(task["trace"]),
                keep)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        launches = {k: v for k, v in sk.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        trace = devtrace.reduce_profile(prof, rank) if prof else None
        del prof, fields
        bad_modules = forbidden_modules()
        last = seed == task["seeds"][-1]
        if last and not task.get("keep_plans"):
            free_program(fwd, bwd)
            del fwd, bwd, calls
        if cuda:
            torch.cuda.empty_cache()
        readings, failed = check(kept, cfg, wl, seed, rank, world, cols,
                                 dev)
        rec = {"rank": rank, "chips": world, "seed": seed,
               "device_name": name, "peak": yardstick.peaks(name),
               "steps": n_steps, "transforms": 2 * n_steps,
               "setup_s": start_wall - task["t0"], "window_s": wall,
               "step_ms": step_ms, "enqueue_s": enq, "peak_bytes": peak,
               "flops_per_step": flops, "bytes_per_step": nbytes,
               "launches": launches, "trace": trace,
               "readings": readings, "failed": failed,
               "forbidden": bad_modules}
        if trace and trace["window"]:
            ws, we = trace["window"]
            print(f"trace coverage rank {rank}: device busy "
                  f"{devtrace.busy_us(trace) * 1e-3:.3f} ms of "
                  f"{(we - ws) * 1e-3:.3f} ms traced, event-timed steps "
                  f"{sum(step_ms):.3f} ms, {len(trace['ops'])} device ops",
                  file=sys.stderr)
        out.append(rec)
        if cuda:
            torch.cuda.empty_cache()
    _barrier(world)
    return out


def rank_entry(task: dict, queue):
    """A spawned rank: runs :func:`run_rank` and puts ("ok", rank,
    records) or ("error", rank, traceback) on ``queue``."""
    try:
        queue.put(("ok", task["rank"], run_rank(task)))
    except BaseException:
        queue.put(("error", task["rank"], traceback.format_exc()))
        raise
    finally:
        try:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        except (RuntimeError, ValueError):
            pass
