"""The readings that a cell's limits are set from, in one process.

    python3 fftbench/readings.py --workload <cell> --seeds 1,2,...
        --control-seeds 7,8,9 [--seconds 1] [--out <file.json>]

Runs the cell's timed path (its plans, interface, fields and a short
window at its own load) once per seed with the plans built once, then
the control, the program's own complex32 path in place of the
configuration's complex64 one, on the control seeds, and prints for each
number compared its readings, the lower reading (the largest the program
gives) and the upper (the smallest the control gives).  The benchmark's
own runs never run it.  Needs the cell's cards, as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fftbench import run  # noqa: E402


def readings(workload, config, seeds, seconds, control, device="cuda"):
    """{seed: {number: value}} over ``seeds`` in one process."""
    per_seed = run.run_cell(workload, config, seeds, seconds, False, device,
                            control=control, keep_plans=True)
    out = {}
    for recs in per_seed:
        worst = {}
        for r in recs:
            for k, v in r["readings"].items():
                worst[k] = max(worst.get(k, 0.0), v)
        out[recs[0]["seed"]] = worst
    return out


def summary(program: dict, control: dict) -> dict:
    names = sorted({k for v in program.values() for k in v})
    return {k: {"lower": max(v[k] for v in program.values()),
                "upper": min(v[k] for v in control.values())
                if control else None} for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _, workload, config = run.load_cell(args.workload)
    run.fix_environment(workload.get("env", {}))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(workload["chips"]):
        print("needs the cell's CUDA devices", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    prog = readings(workload, config, seeds, args.seconds, False)
    ctrl = readings(workload, config, cseeds, args.seconds, True) \
        if cseeds else {}
    for tag, got in (("program", prog), ("control", ctrl)):
        for seed, nums in got.items():
            print(tag, seed, " ".join(f"{k} {v:.4g}" for k, v in
                                      sorted(nums.items())))
    res = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "program": prog, "control": ctrl,
           "summary": summary(prog, ctrl)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
