"""Run one cell of the port's benchmark once.

    python3 fftbench/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is
``fftbench/workloads/<cell>.json`` (its traffic), which names its
configuration ``fftbench/configs/<config>.json``;
the metrics it reports are the ``BENCHMARK.json`` entries that list it (or
list no cells), each read by ``fftbench/metrics/<metric>.py``.  With
``--trace 0`` the line carries the end-to-end metrics, with ``--trace 1``
the per-layer ones, read from a profiler trace of the window.

The program measured is the port, ``regent_fft_tpu_torch``.  Nothing here
imports JAX or the JAX package; after the window the process that prints
the result checks ``sys.modules`` for them and fails if it finds one.
Before the port is imported, every ``REGENT_FFT_*`` variable that the cell
does not set is cleared, wisdom is switched off, and the kernel caches
are pinned inside the checkout (``build/``), so an ambient switch or a
wisdom file cannot change the route measured.

Standard error carries each plan's ``describe()``, the switches in force,
the card's name, count and power limit, the trace's coverage, and last
the numbers compared with their limits.  The last line of standard output
is the result (one JSON object).  Exit 2 without a result where the cell
needs cards that are not there.
"""
from __future__ import annotations

import time

T0 = time.time()     # process start, as near as the interpreter sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RANK_TIMEOUT_S = 330


def load_cell(name: str, root: Path = ROOT) -> tuple:
    """(BENCHMARK.json, the workload, its configuration) of cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if name not in {w["name"] for w in bench["workloads"]}:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = json.loads(
        (root / "fftbench" / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (root / "fftbench" / "configs" / f"{workload['config']}.json")
        .read_text())
    return bench, workload, config


def fix_environment(cell_env: dict, root: Path = ROOT, env=None) -> None:
    """The program's environment for the run (``os.environ`` unless
    ``env`` is given): only the cell's own ``REGENT_FFT_*`` switches, no
    wisdom, build and kernel caches at fixed paths inside the checkout."""
    env = os.environ if env is None else env
    for k in list(env):
        if k.startswith("REGENT_FFT_"):
            del env[k]
    env.update({k: str(v) for k, v in cell_env.items()})
    env["REGENT_FFT_NO_WISDOM"] = "1"
    cache = root / "build" / "fftbench"
    env["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(cache / "triton")


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The ``section`` metrics that cell ``cell`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, recs: list):
    import importlib.util
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fftbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(recs)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_ranks(task: dict, world: int) -> list:
    """The records of every rank, rank order, one list per seed: in this
    process for one rank, else one spawned process a rank, joined over a
    rendezvous file under the temporary directory."""
    from fftbench import cell
    if world == 1:
        return [[r] for r in cell.run_rank(dict(task, rank=0, world=1))]
    import multiprocessing as mp
    import queue as queue_mod
    import shutil
    import tempfile
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rdzv = tempfile.mkdtemp(prefix="fftbench-rdzv-")
    procs = []
    try:
        for r in range(world):
            t = dict(task, rank=r, world=world,
                     init_method=f"file://{rdzv}/store")
            p = ctx.Process(target=cell.rank_entry, args=(t, q))
            p.start()
            procs.append(p)
        got, deadline = {}, time.time() + RANK_TIMEOUT_S
        while len(got) < world:
            try:
                status, rank, payload = q.get(
                    timeout=max(1.0, deadline - time.time()))
            except queue_mod.Empty:
                raise RuntimeError("ranks timed out") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=60)
        return [list(recs) for recs in zip(*(got[r] for r in range(world)))]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(rdzv, ignore_errors=True)


def result(bench: dict, workload: dict, recs: list, trace: bool,
           platform: str) -> tuple:
    """(the result object, the check lines) of one seed's records; no
    result where a process loaded JAX or the JAX package."""
    from fftbench import cell, devtrace, reference, records
    name = workload["name"]
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, name, section):
        v = read_metric(m["name"], recs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    worst = {}
    for r in recs:
        for k, v in r["readings"].items():
            worst[k] = max(worst.get(k, 0.0), v)
    judged = reference.judge(worst, workload["limits"])
    bad = sorted(set(cell.forbidden_modules()).union(
        *(r["forbidden"] for r in recs)))
    correct = all(ok for *_, ok in judged) and all(
        math.isfinite(m["value"]) for m in metrics.values())
    device = {"platform": platform, "kind": recs[0]["device_name"],
              "count": len(recs),
              "memory_peak_bytes": max(r["peak_bytes"] for r in recs)}
    out = {"correct": correct, "attempted": recs[0]["transforms"],
           "failed": max(r["failed"] for r in recs),
           "metrics": metrics, "device": device}
    if trace and records.traced(recs):
        device["busy_s"] = records.mean(records.busy_s(r) for r in recs)
        device["window_s"] = records.mean(records.traced_window_s(r)
                                          for r in recs)
        out["breakdown"] = devtrace.breakdown(recs[0]["trace"])
    out["checks"] = {k: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for k, v, lim, _ in judged}
    lines = [f"check {k} {v:.6g} limit {lim:.6g} {'ok' if ok else 'FAIL'}"
             for k, v, lim, ok in judged]
    if bad:
        lines.append(f"forbidden modules loaded, no result: {', '.join(bad)}")
        return None, lines
    return out, lines


def run_cell(workload: dict, config: dict, seeds, seconds: float,
             trace: bool, device: str = "cuda", control: bool = False,
             patch: str = None, keep_plans: bool = False) -> list:
    """Every rank's records of the cell, one list per seed.  ``control``
    runs the program's complex32 path in place of the configuration's
    dtype; ``patch`` ("module:function") is called in every rank before
    planning (a test's planted fault); ``keep_plans`` keeps the plans
    across seeds."""
    world = int(workload["chips"])
    task = {"workload": workload, "config": config, "seeds": list(seeds),
            "seconds": float(seconds), "trace": bool(trace),
            "device": device, "control": control, "patch": patch,
            "keep_plans": keep_plans, "t0": T0}
    return run_ranks(task, world)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, workload, config = load_cell(args.workload)
    fix_environment(workload.get("env", {}))
    import torch
    chips = int(workload["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    # the card's name comes from the ranks: this process makes no CUDA
    # context of its own where ranks are spawned
    print(f"devices: {chips} of {have}; nvidia-smi name, power.limit: "
          f"{power_limit()}", file=sys.stderr)
    return run_and_print(bench, workload, config, args.seed, args.seconds,
                         bool(args.trace), "cuda", "gpu")


def run_and_print(bench, workload, config, seed, seconds, trace, device,
                  platform, patch=None) -> int:
    """Everything after the look for cards: run the cell once, print the
    check lines on standard error and the result line; 3 without a
    result where a forbidden module was loaded."""
    recs = run_cell(workload, config, [seed], seconds, trace, device,
                    patch=patch)[0]
    out, lines = result(bench, workload, recs, trace, platform)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    if out is None:
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
