#!/usr/bin/env python3
"""Run a benchmark cell (``fftbench/``) with the port's spans on or off and
read the layers they name, without touching the benchmark's files.

    python3 scripts/torch_trace_spans.py --workload <cell> --seeds <n,...>
        --seconds <s> --runs <spans:trace,...> [--out <file.jsonl>]

from the root of a checkout.  Each entry of ``--runs`` runs the cell once
for every seed, through ``fftbench/run.py``'s own ``run_cell`` (the same
plans, fields, window and check), with the port's spans switched on or off
(``utils/trace.py``) in every rank before it plans, and with or without
the profiler over the window.  The ranks' trace reduction also keeps what
the spans and counters give:

* ``span_device_us``: the window's device µs by the innermost ``rft.``
  span that holds each operation's launch (``trace.device_us_by_span``);
* ``launch_bytes``, ``launches`` and ``counts``: the port's counters over
  the window (``stockham_kernels.LAUNCH_BYTES``/``LAUNCHES``,
  ``trace.COUNTS``, reset as the window starts).

One JSON line a run, on standard output and appended to ``--out``: the
benchmark's own metrics (``fftbench/metrics``) and, from a traced run, the
figures the spans and counters read, a mean over ranks:

* ``layout_ms``: device ms a step under ``rft.layout.*``;
* ``exchange_copy_ms``: under ``rft.exchange.pack`` and ``.unpack``;
  ``scale_ms`` under ``rft.scale``;
* ``exchange_gbps``: ``exchange_bytes`` a step over NCCL's device time a
  step (``nccl_ms``);
* ``kernel_gbps``: ``LAUNCH_BYTES`` a step over the port's kernels' device
  time a step (``kernel_ms``), and ``launch_gib_per_step``, both without
  ``contract_gemm`` (the contraction steps' products, cuBLAS's kernels);
* ``fused2_planes_per_step``: the planes ``fft_fused2``'s register body
  took a step (``trace.COUNTS["fused2_planes"]``);
  ``interleaved_in_per_step``/``interleaved_out_per_step``: the
  transforms a step whose first kernel read the caller's complex64 tensor
  and whose last kernel wrote the returned one
  (``trace.COUNTS["interleaved_in"]``/``["interleaved_out"]``; 2 a step
  where both of a C2C step's transforms take both ends);
* ``attributed_pct``: the share of device µs under some ``rft.`` span;
  ``port_records`` against ``launches``: the port-class kernel records
  in the trace against the launches counted, ``contract_gemm`` left out
  (the profiler's dropped records);
* ``idle_gaps``: the ten longest idle gaps, named by the benchmark's span
  and the innermost ``rft.`` span at their midpoint, with the CUDA calls
  of 100 µs or more that overlap them.

An untraced run gives ``host_ms`` (host ms a step inside the benchmark's
calls into the port) with the spans on or off: their cost off the
profiler.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

SLOW_CALL_US = 100.0     # CUDA runtime and driver calls kept by name


def _install():
    """In a rank: keep the spans' and counters' readings in the reduced
    trace, and reset ``trace.COUNTS`` with the launch counters."""
    from fftbench import devtrace, kernel_class
    from regent_fft_tpu_torch.ops import stockham_kernels as sk
    from regent_fft_tpu_torch.utils import trace
    if getattr(devtrace.reduce_events, "keeps_spans", False):
        return
    reduce_events, reset_launches = devtrace.reduce_events, sk.reset_launches

    def reduce_with_spans(events):
        events = list(events)
        out = reduce_events(events)
        out["launch_bytes"] = {k: v for k, v in sk.LAUNCH_BYTES.items() if v}
        out["launches"] = {k: v for k, v in sk.LAUNCHES.items() if v}
        out["counts"] = dict(trace.COUNTS)
        if out["window"]:
            ws, we = out["window"]
            out["span_device_us"] = trace.device_us_by_span(events,
                                                            out["window"])
            out["program_spans"] = [
                [e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(trace.PREFIX)
                and ws <= float(e["ts"]) < we]
            out["port_records"] = sum(1 for o in out["ops"]
                                      if o[1] == kernel_class.PORT)
            out["slow_calls"] = [
                [e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                for e in events if e.get("ph") == "X"
                and e.get("cat") in trace.LAUNCH_CATS
                and float(e.get("dur", 0)) >= SLOW_CALL_US
                and ws <= float(e["ts"]) < we]
        return out
    reduce_with_spans.keeps_spans = True

    def reset_all():
        reset_launches()
        trace.reset_counts()
    devtrace.reduce_events = reduce_with_spans
    sk.reset_launches = reset_all


def spans_on():
    from regent_fft_tpu_torch.utils import trace
    _install()
    trace.set_tracing(True)


def spans_off():
    from regent_fft_tpu_torch.utils import trace
    _install()
    trace.set_tracing(False)


def _innermost(spans, t):
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else None


def figures(recs) -> dict:
    """The spans' and counters' readings of one traced run's records."""
    from fftbench import kernel_class as kc, records, yardstick
    from regent_fft_tpu_torch.ops import stockham_kernels as sk
    if not records.traced(recs) or "span_device_us" not in recs[0]["trace"]:
        return {}
    out, per = {}, []
    for r in recs:
        tr, steps = r["trace"], r["steps"]
        by = tr["span_device_us"]
        total = sum(by.values())

        def ms(pred):
            return sum(v for k, v in by.items() if pred(k)) * 1e-3 / steps
        kernel_ms = records.class_ms_per_step(r, (kc.PORT,))
        nccl_ms = records.class_ms_per_step(r, (kc.NCCL,))
        lb = sum(v for k, v in tr["launch_bytes"].items()
                 if k not in sk.LIBRARY_LAUNCHES) / steps
        xb = tr["counts"].get("exchange_bytes", 0) / steps
        per.append({
            "layout_ms": ms(lambda k: k.startswith("rft.layout.")),
            "exchange_copy_ms": ms(lambda k: k in ("rft.exchange.pack",
                                                   "rft.exchange.unpack")),
            "scale_ms": ms(lambda k: k == "rft.scale"),
            "exchange_gbps": xb / (nccl_ms * 1e-3) / 1e9 if nccl_ms and xb
            else None,
            "kernel_gbps": lb / (kernel_ms * 1e-3) / 1e9 if kernel_ms and lb
            else None,
            "launch_gib_per_step": lb / 2 ** 30,
            "exchange_gib_per_step": xb / 2 ** 30,
            "fused2_planes_per_step": tr["counts"].get("fused2_planes", 0)
            / steps,
            "interleaved_in_per_step": tr["counts"].get("interleaved_in", 0)
            / steps,
            "interleaved_out_per_step": tr["counts"].get("interleaved_out",
                                                         0) / steps,
            "attributed_pct": 100.0 * (1 - by.get("unattributed", 0.0)
                                       / total) if total else None,
            "port_records": tr["port_records"],
            "launches": sum(v for k, v in tr["launches"].items()
                            if k not in sk.LIBRARY_LAUNCHES),
            "span_ms_per_step": {k: v * 1e-3 / steps
                                 for k, v in sorted(by.items())}})
    for k in per[0]:
        vals = [p[k] for p in per]
        if k == "span_ms_per_step" or any(v is None for v in vals):
            out[k] = vals[0] if k == "span_ms_per_step" else None
        else:
            out[k] = sum(vals) / len(vals)
    tr = recs[0]["trace"]
    ws, we = tr["window"]
    idle = yardstick.gaps([(o[2], o[3]) for o in tr["ops"]], ws, we)
    idle.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in idle[:10]:
        mid = 0.5 * (a + b)
        host = next((n for n, s, t in tr["spans"] if s <= mid < t), "loop")
        prog = _innermost(tr["program_spans"], mid)
        calls = sorted({n for n, s, t in tr["slow_calls"] if s < b and t > a})
        named.append([host + (f"/{prog}" if prog else ""), (b - a) * 1e-6,
                      calls])
    out["idle_gaps"] = named
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--runs", default="1:1",
                    help="spans:trace pairs, comma-separated, in order")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from fftbench import run
    bench, workload, config = run.load_cell(args.workload)
    run.fix_environment(workload.get("env", {}))
    import torch
    if torch.cuda.device_count() < int(workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} CUDA device(s)",
              file=sys.stderr)
        return 2
    print(f"nvidia-smi name, power.limit: {run.power_limit()}",
          file=sys.stderr)
    for pair in args.runs.split(","):
        spans, traced = (bool(int(v)) for v in pair.split(":"))
        for seed in (int(s) for s in args.seeds.split(",")):
            recs = run.run_cell(
                workload, config, [seed], args.seconds, traced,
                patch="torch_trace_spans:" + ("spans_on" if spans
                                              else "spans_off"))[0]
            line = {"workload": args.workload, "seed": seed, "spans": spans,
                    "trace": traced, "steps": recs[0]["steps"],
                    "failed": max(r["failed"] for r in recs)}
            listed = {m["name"] for m in run.cell_metrics(
                bench, args.workload,
                "per_layer" if traced else "end_to_end")}
            for m in sorted(listed | {"host_ms"}):
                line[m] = run.read_metric(m, recs)
            line.update(figures(recs))
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
