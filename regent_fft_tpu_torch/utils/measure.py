"""Measure-mode planning: candidates raced on the plan's device.

Counterpart: ``regent_fft_tpu/utils/measure.py`` (FFTW_MEASURE, PATIENT
and EXHAUSTIVE, ``kernel/planner.c``: time candidate solvers and keep the
winner as wisdom).  The candidates are radix schedules of the contraction
steps (:func:`measure_schedule`), whole-plan backends
(:func:`measure_backends`), the leading-axis and trailing-pair routes
(:func:`measure_patient`) and the kernel knobs (:func:`measure_exhaustive`).
Every candidate is timed by ``utils/timing.py`` (one untimed call, then
the median of CUDA-event runs with the L2 flushed) after the kernel
library is built.

A candidate whose *plan build* raises its route's own refusal
(``NotImplementedError`` or ``ValueError``) records ``inf``; an error while
*running* a candidate is a launch or build failure and propagates.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from ..ops import factor as _factor

#: ``fftw_set_timelimit(FFTW_NO_TIMELIMIT)`` analog (no planning cap).
NO_TIMELIMIT = -1.0

try:
    _TIMELIMIT = float(os.environ.get("REGENT_FFT_TIMELIMIT", NO_TIMELIMIT))
except ValueError:  # a malformed value must not make the package unimportable
    _TIMELIMIT = NO_TIMELIMIT

# Most elements of the planes a schedule race times (measure_plan_sizes).
MAX_RACE_ELEMS = 1 << 24

# Errors by which a route refuses a candidate when its plan is built.
REFUSED = (NotImplementedError, ValueError)

# The JAX package's exhaustive knobs (measure.py:466-472), none of which
# selects a different kernel instance or plain body in the port, so the
# port races none of them:
# * REGENT_FFT_TAIL_MT: the tail length of the TPU tile; the CUDA kernels
#   take their stage lists from last_stages/cols_stages/fused2_stages,
#   and the plain tile's TAIL_MT is a constant;
# * REGENT_FFT_MXU_IMPL: the bf16 tile body; on the card the f32 tile of
#   the bf16 instances stands in for both bodies, and the plain
#   versions run the default body;
# * REGENT_FFT_F2_STRIPS: the strip depth of the grid fused2 body
#   (pallas_stockham.py:897); fft_fused2 is a cluster kernel with no
#   strips, and the ring's sub-slab count S is the TPU's
#   REGENT_FFT_F2_RING_STRIPS, fixed by the TMA box geometry
#   (stockham_kernels.axes2_ring_geometry).
RACED_KNOBS: frozenset = frozenset()


def set_timelimit(seconds: float) -> None:
    """Cap the time of each race (``fftw_set_timelimit`` analog).

    Once ``seconds`` of wall time have passed in a race, it times no
    further candidate, but never before one candidate has timed
    successfully (``inf`` does not count).  ``NO_TIMELIMIT`` (negative)
    removes the cap.  Counterpart: ``utils/measure.py:33``.
    """
    global _TIMELIMIT
    _TIMELIMIT = float(seconds)


def get_timelimit() -> float:
    """The planning time cap in seconds (negative: none)."""
    return _TIMELIMIT


class _PlanDeadline:
    """A race's deadline: :meth:`over` once the cap has passed and a
    finite time exists.  Counterpart: ``utils/measure.py:56``."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def over(self, timings: dict) -> bool:
        if _TIMELIMIT < 0 or (time.perf_counter() - self.t0) <= _TIMELIMIT:
            return False
        return any(v != float("inf") for v in timings.values())


def _prepare(device) -> None:
    """Build the kernel library before a race on the card, so no
    candidate's time holds nvcc."""
    if torch.device(device).type == "cuda":
        from ..ops import _build
        _build.load()


def candidate_schedules(n: int, max_radix: int = 128, cap: int = 8,
                        deep: bool = False) -> List[Tuple[int, ...]]:
    """Distinct radix schedules for n, the likeliest first: greedy, the
    cost model's, the balanced one, every two-factor split; ``deep``
    (EXHAUSTIVE) adds both orders of each split and the three-factor
    splits and lifts the cap to 24.  Counterpart: ``measure.py:78``."""
    cands = []

    def add(s):
        if s and s not in cands and int(np.prod(s)) == n:
            cands.append(tuple(s))

    add(_factor.factorize(n, max_radix))
    from ..native import planner as _native
    s = _native.best_schedule(n, max_radix)
    if s:
        add(tuple(sorted(s, reverse=True)))
    add(_factor.pallas_schedule(n, max_radix))
    f = 2
    while f * f <= n:
        if n % f == 0 and f <= max_radix and n // f <= max_radix:
            add(tuple(sorted((f, n // f), reverse=True)))
            if deep:
                add(tuple(sorted((f, n // f))))
        f += 1
    if n <= max_radix:
        add((n,))
    if deep:
        cap = max(cap, 24)
        f1 = 2
        while f1 ** 3 <= n:
            if n % f1 == 0 and f1 <= max_radix:
                m = n // f1
                f2 = f1
                while f2 * f2 <= m:
                    if m % f2 == 0 and f2 <= max_radix \
                            and m // f2 <= max_radix:
                        add(tuple(sorted((f1, f2, m // f2), reverse=True)))
                    f2 += 1
            f1 += 1
    return cands[:cap]


def time_fn(build, batch_shape, k: int = 10, seed: int = 0,
            device="cuda") -> float:
    """Seconds per call of ``build(xr, xi)`` on seeded normal f32 planes
    of ``batch_shape`` on ``device``: the median of ``k`` timed runs after
    one untimed call.  Counterpart: ``measure.py:132``."""
    from . import timing as _timing
    g = torch.Generator(device=device).manual_seed(seed)
    xr = torch.randn(batch_shape, generator=g, device=device)
    xi = torch.randn(batch_shape, generator=g, device=device)
    return 1e-3 * _timing.time_ms(lambda: build(xr, xi), k, device)


def _schedule_step_fn(n: int, sched, sign: int, use_3m: bool):
    """The step the executor runs for this schedule along axis 1: one
    direct contraction, the two-stage ``mixed_radix_fft_axis``, or the
    flattened ``mixed_radix_fft`` pipeline (``plan.axis_steps``' three
    contraction kinds).  Counterpart: ``measure.py:143``."""
    from ..ops.stockham import (direct_dft_axis, mixed_radix_fft,
                                mixed_radix_fft_axis)
    if len(sched) == 1:
        return lambda xr, xi: direct_dft_axis(xr, xi, 1, n, sign, use_3m)
    if len(sched) == 2:
        n1 = sched[0]
        return lambda xr, xi: mixed_radix_fft_axis(xr, xi, 1, n, n1, sign,
                                                   use_3m)
    return lambda xr, xi: mixed_radix_fft(xr, xi, n, sched, sign, use_3m)


def measure_schedule(n: int, direction=None, precision: str = "highest",
                     batch: int = 1024, max_radix: int = 128,
                     k: int = 10, install: bool = True,
                     use_3m: bool = False, deep: bool = False,
                     device="cuda") -> Tuple[Tuple[int, ...], dict]:
    """Time the candidate schedules of length n on (batch, n) planes on
    ``device``; return (winner, {"r1 r2 ...": seconds}).  With
    ``install`` the winner becomes the schedule override every later plan
    of this length takes.  ``precision`` is kept for the JAX signature:
    the port computes exact f32 at every tier.  The override is keyed
    with ``device``'s type: a CPU race never steers a CUDA plan.
    Counterpart: ``measure.py:164``."""
    from ..dtypes import Direction
    direction = Direction.FORWARD if direction is None else direction
    sign = int(direction)
    _prepare(device)
    timings = {}
    deadline = _PlanDeadline()
    for sched in candidate_schedules(n, max_radix, deep=deep):
        if deadline.over(timings):
            break
        try:
            step = _schedule_step_fn(n, sched, sign, use_3m)
        except REFUSED:
            timings[sched] = float("inf")
            continue
        timings[sched] = time_fn(step, (batch, n), k=k, device=device)
    winner = min(timings, key=timings.get)
    if install and timings[winner] < float("inf"):
        _factor.set_schedule_override(n, winner, max_radix, device)
    return winner, {" ".join(map(str, s)): t for s, t in timings.items()}


def _race(candidates, build_core, reps: int) -> dict:
    """{name: seconds} of each (name, spec) candidate: its plan built by
    ``build_core`` (``inf`` where the route refuses it), then timed by
    ``timing.time_plan``, under the time limit."""
    from . import timing as _timing
    timings = {}
    deadline = _PlanDeadline()
    for name, spec in candidates:
        if name in timings:
            continue
        if deadline.over(timings):
            break
        try:
            core = build_core(spec)
        except REFUSED:
            timings[name] = float("inf")
            continue
        timings[name] = _timing.time_plan(core, reps=reps)
    return timings


def _pow2_ok(n: int) -> bool:
    from ..ops import stockham_kernels as _sk
    return 2 <= n <= _sk.MAX_STOCKHAM_N and (n & (n - 1)) == 0


def backend_candidates(spec) -> List[str]:
    """The backends :func:`measure_backends` races: "xla" always; on a
    CUDA plan, "stockham" and "pallas" when every dispatched axis is a
    power of two <= MAX_STOCKHAM_N, and "hybrid" always.  The JAX package
    gates the kernel backends on a TPU backend (measure.py:230) and races
    "hybrid" only where the last axis passes the same gate; the port
    always races it on the card, because it is the backend an estimate
    plan there takes (``plan._auto_backend``), and a race that left it out
    would store a winner that never beat it (64 x 2^20 would race "xla"
    alone).  A CPU plan races "xla" alone in both packages."""
    from ..dtypes import Kind
    lengths = list(spec.transform_lengths)
    if spec.kind in (Kind.R2C, Kind.C2R):
        lengths = [spec.shape[a] for a in spec.axes[:-1]]
    cands = ["xla"]
    if torch.device(spec.device).type == "cuda" and lengths:
        if all(_pow2_ok(n) for n in lengths):
            cands += ["stockham", "pallas"]
        cands.append("hybrid")
    return cands


def measure_backends(spec, build_core, reps: int = 10):
    """Time the whole plan under each backend of
    :func:`backend_candidates`; return (winner, {backend: seconds}).
    ``build_core(spec)`` builds an unraced plan.
    Counterpart: ``measure.py:206``."""
    _prepare(spec.device)
    timings = _race([(b, dataclasses.replace(spec, backend=b))
                     for b in backend_candidates(spec)], build_core, reps)
    return min(timings, key=timings.get), timings


def _patient_candidates(spec, build_core):
    """(name, spec) of the leading-axis x trailing-pair routes a plan can
    take: ``f2_impl`` ring|off where it has a trailing-pair step,
    ``axis0_impl`` fourstep|dma|grid where it has a non-last butterfly
    step or a pair.  Counterpart: ``measure.py:284-306``."""
    base = dataclasses.replace(spec, planner="estimate")
    steps = build_core(base).steps
    ndim = len(spec.shape)
    has_f2 = any(k in ("stockham2", "fused2_ring") for k, _, _ in steps)
    has_mid = any(k in ("stockham", "fourstep_ring", "dma_ring")
                  and a != ndim - 1 for k, a, _ in steps)
    f2_opts = ["auto"] + (["ring", "off"] if has_f2 else [])
    a0_opts = ["auto"] + (["fourstep", "dma", "grid"]
                          if (has_mid or has_f2) else [])
    return [(f"axis0={a0} f2={f2}",
             dataclasses.replace(base, axis0_impl=a0, f2_impl=f2))
            for f2 in f2_opts for a0 in a0_opts]


def measure_patient(spec, build_core, reps: int = 10):
    """PATIENT race: the leading-axis route (``axis0_impl`` auto,
    fourstep, dma, grid) x the trailing-pair route (``f2_impl`` auto,
    ring, off), pruned to what the plan can take.  Returns
    (winner {"axis0_impl", "f2_impl", "backend"}, {"axis0=.. f2=..":
    seconds}).  Counterpart: ``measure.py:259``."""
    _prepare(spec.device)
    cands = _patient_candidates(spec, build_core)
    timings = _race(cands, build_core, reps)
    w = dict(cands)[min(timings, key=timings.get)]
    return ({"axis0_impl": w.axis0_impl, "f2_impl": w.f2_impl,
             "backend": w.backend}, timings)


def knob_combos(spec, steps) -> List[dict]:
    """The JAX package's exhaustive knob grid for a plan (measure.py:
    466-478): REGENT_FFT_MXU_IMPL direct|fstw for complex32, else
    REGENT_FFT_TAIL_MT 32|64, and REGENT_FFT_F2_STRIPS 2|4 where a
    trailing-pair step exists (``stockham2``, or its ring route, which
    the JAX package takes inside the same step); defaults ({}) first."""
    axes = []
    if spec.dtype == "complex32":
        axes.append(("REGENT_FFT_MXU_IMPL", ("direct", "fstw")))
    else:
        axes.append(("REGENT_FFT_TAIL_MT", ("32", "64")))
    if any(k in ("stockham2", "fused2_ring") for k, _, _ in steps):
        axes.append(("REGENT_FFT_F2_STRIPS", ("2", "4")))
    combos = [{}]
    for name, vals in axes:
        combos = combos + [dict(c, **{name: v})
                           for c in combos if name not in c for v in vals]
    return combos


def knob_name(knobs: dict) -> str:
    """"tail_mt=32 f2_strips=4"-style name of a combo ("defaults" for
    {}).  Counterpart: ``measure.py:482``."""
    return " ".join(f"{k[len('REGENT_FFT_'):].lower()}={v}"
                    for k, v in sorted(knobs.items())) or "defaults"


def measure_exhaustive(spec, build_core, reps: int = 10):
    """EXHAUSTIVE race: PATIENT, then the knob combos of
    :func:`knob_combos` on the patient winner.  Returns (winner: the
    patient dict with "knobs", {"patient": {...}, "knobs": {...}}); the
    plan would keep the knobs on itself, never in ``os.environ``.  No
    knob selects a kernel on the device (``RACED_KNOBS`` is empty), so the
    only combo is the defaults, whose time is the patient winner's: it is
    not timed again, and "knobs" is {}.  The deep schedule space is raced
    by ``measure_plan_sizes(deep=True)``.  Counterpart: ``measure.py:429``.
    """
    pw, ptimings = measure_patient(spec, build_core, reps)
    winner = dict(pw, knobs={})
    return winner, {"patient": ptimings,
                    "knobs": {"defaults": min(ptimings.values())}}


def measure_plan_sizes(spec, batch: int = 1024, k: int = 10,
                       deep: bool = False) -> dict:
    """:func:`measure_schedule` for every smooth transform length of a
    spec, on its device, on ``batch`` rows, fewer where batch x n would
    pass ``MAX_RACE_ELEMS`` (a 2^20-point length races 16 rows, not the
    1024 that would hold 8 GiB of planes).
    Counterpart: ``measure.py:502``."""
    from ..plan import resolve_device
    device = resolve_device(spec.device)
    results = {}
    for n in sorted(set(spec.transform_lengths)):
        if n < 2 or _factor.factorize(n, spec.max_radix) is None:
            continue
        winner, t = measure_schedule(
            n, spec.direction, spec.precision,
            batch=max(1, min(batch, MAX_RACE_ELEMS // n)),
            max_radix=spec.max_radix, k=k, use_3m=spec.use_3m, deep=deep,
            device=device)
        results[n] = {"winner": winner, "timings": t}
    return results
