"""Benchmark and verify CLI of the port, in FFTW's problem grammar.

Counterpart: ``regent_fft_tpu/bench_cli.py`` (the conventions of FFTW's
``libbench2`` and ``tests/README``):

  problem := [i|o][r|c][f|b]<size>[x<size>]*
    i/o  in-place / out-of-place (the plans never write their input)
    r/c  real / complex transform
    f/b  forward / backward
    e.g. ocf1024   out-of-place complex forward, N=1024
         irb512x512 in-place real backward (C2R), 512x512

"mflops" follow libbench2/mflops.c: 5 N log2(N) / t (half for real).  The
time is the port's one method (``utils/timing.py``: the median of CUDA-event
runs of the plan's split-plane core, the L2 flushed before each, on the
card); ``--latency`` times ``plan(x)`` from a host array instead, the round
trip included.  ``--verify`` runs FFTW's verify-dft identities (impulse,
linearity, time shift) and a float64 golden check, PASS or FAIL.

Usage:
  python -m regent_fft_tpu_torch.bench_cli ocf1024 --batch 1024
  python -m regent_fft_tpu_torch.bench_cli icf256x256x256 --verify
  python -m regent_fft_tpu_torch.bench_cli --suite baseline
  python -m regent_fft_tpu_torch.bench_cli --suite smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_PROBLEM_RE = re.compile(r"^([io])([rc])([fb])(\d+(?:x\d+)*)$")


@dataclass(frozen=True)
class Problem:
    in_place: bool
    real: bool
    forward: bool
    sizes: Tuple[int, ...]

    @property
    def n(self) -> int:
        return int(np.prod(self.sizes))

    def __str__(self):
        return (f"{'i' if self.in_place else 'o'}{'r' if self.real else 'c'}"
                f"{'f' if self.forward else 'b'}" + "x".join(map(str, self.sizes)))


def parse_problem(s: str) -> Problem:
    """Counterpart: ``regent_fft_tpu/bench_cli.py:63``."""
    m = _PROBLEM_RE.match(s.strip())
    if not m:
        raise ValueError(
            f"bad problem {s!r}: expected [i|o][r|c][f|b]<size>[x<size>...] "
            "(fftw-3.3.8/tests/README grammar)")
    return Problem(
        in_place=m.group(1) == "i",
        real=m.group(2) == "r",
        forward=m.group(3) == "f",
        sizes=tuple(int(t) for t in m.group(4).split("x")),
    )


def _build_plan(prob: Problem, batch: int, precision: str, backend: str,
                planner: str, device: str):
    from .dtypes import Direction, Kind, Norm
    from .plan import PlanSpec, make_plan

    shape = ((batch,) if batch > 1 else ()) + prob.sizes
    axes = tuple(range(len(shape) - len(prob.sizes), len(shape)))
    if prob.real:
        kind = Kind.R2C if prob.forward else Kind.C2R
    else:
        kind = Kind.C2C
    direction = Direction.FORWARD if prob.forward else Direction.BACKWARD
    spec = PlanSpec(shape=shape, axes=axes, kind=kind, direction=direction,
                    norm=Norm.BACKWARD, precision=precision, backend=backend,
                    donate=prob.in_place, planner=planner, device=device)
    return make_plan(spec)


def _make_input(prob: Problem, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shape = ((batch,) if batch > 1 else ()) + prob.sizes
    if prob.real and prob.forward:
        return rng.standard_normal(shape).astype(np.float32)
    if prob.real:  # C2R input: the half spectrum of the real shape
        hs = list(shape)
        hs[-1] = hs[-1] // 2 + 1
        return (rng.standard_normal(hs) + 1j * rng.standard_normal(hs)
                ).astype(np.complex64)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def run_problem(prob: Problem, batch: int = 1, iters: int = 10,
                precision: str = "highest", backend: str = "auto",
                planner: str = "estimate", verify: bool = False,
                latency: bool = False, device: str = "cuda") -> dict:
    """One row: the plan's first step line, its time (median of ``iters``
    or, with ``latency``, the fastest round trip), mflops and with
    ``verify`` the checks.  Counterpart: ``bench_cli.py:110``."""
    from .utils import flopcount
    from .utils import timing
    from .utils import verify as V

    plan = _build_plan(prob, batch, precision, backend, planner, device)
    x = _make_input(prob, batch)
    plan(x)
    if latency:
        dt = timing.time_plan_latency(plan, iters=iters)
    else:
        dt = timing.time_plan(plan, reps=iters)
    mflops = flopcount.mflops_convention(prob.n, dt, real=prob.real) * max(batch, 1)
    out = {
        "problem": str(prob),
        "setup": plan.describe().splitlines()[0],
        "time_us": dt * 1e6,
        "mflops": mflops,
        "batch": batch,
        "methodology": "latency" if latency else timing.methodology(plan.device),
    }
    if verify:
        res = V.verify_plan(plan, x=x)
        out["verify"] = {"rel_l2": res["rel_l2"], "tol": res["tol"],
                         "status": "PASS" if res["ok"] else "FAIL"}
        if not prob.real and len(prob.sizes) == 1 and batch == 1:
            from .api import fft

            def fft1(v):
                return fft(v, device=device)
            n = prob.sizes[0]
            out["verify"]["impulse"] = V.check_impulse(fft1, n)
            out["verify"]["linearity"] = V.check_linearity(fft1, n)
            out["verify"]["shift"] = V.check_shift(fft1, n)
    return out


SUITES = {
    # the reference's test matrix (test/fft_test.rg:138-388) as problems,
    # and BASELINE.md's configurations
    "smoke": ["ocf3", "orf6", "ocb5", "ocf2x2", "ocf3x2x2", "orf4x2x2"],
    "baseline": ["ocf1024", "orf1024", "ocf512x512", "ocf128x128x128",
                 "orf128x128x128", "ocb1024"],
    "full": ["ocf1024", "ocb1024", "orf1024", "orb1024", "ocf4096",
             "ocf360", "ocf509", "ocf512x512", "ocb512x512",
             "ocf128x128x128", "orf128x128x128", "orb128x128x128"],
}


def main(argv=None):
    """Counterpart: ``regent_fft_tpu/bench_cli.py:170``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("problems", nargs="*", help="problem strings (grammar above)")
    ap.add_argument("--suite", choices=sorted(SUITES), help="named problem set")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "xla", "pallas", "stockham", "hybrid"])
    ap.add_argument("--planner", default="estimate",
                    choices=["estimate", "model", "measure", "patient",
                             "exhaustive"])
    ap.add_argument("--device", default="cuda",
                    help="the plans' device (default the card; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--latency", action="store_true",
                    help="plan(x) from a host array, round trip included")
    ap.add_argument("--json", action="store_true", help="one JSON line per problem")
    args = ap.parse_args(argv)

    problems = list(args.problems)
    if args.suite:
        problems += SUITES[args.suite]
    if not problems:
        ap.error("no problems given (positional or --suite)")

    failed = 0
    for ps in problems:
        prob = parse_problem(ps)
        res = run_problem(prob, args.batch, args.iters, args.precision,
                          args.backend, args.planner, args.verify,
                          latency=args.latency, device=args.device)
        if args.json:
            print(json.dumps(res))
        else:
            line = (f"{res['problem']:>16}  {res['time_us']:10.1f} us  "
                    f"{res['mflops']:12.1f} mflops")
            if "verify" in res:
                v = res["verify"]
                line += f"  [{v['status']} rel={v['rel_l2']:.2e} tol={v['tol']:.1e}]"
            print(line)
        if res.get("verify", {}).get("status") == "FAIL":
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
