"""The port's measure, patient and exhaustive races (``utils/measure.py``)
against the JAX package's under the same injected timings: the same
candidates, times and winners, the same schedule overrides, and plans with
the JAX plans' step lines and outputs.  The timers of both packages are
replaced by a hash of the candidate (JAX ``time_chain``/``time_fn``, the
port's ``timing.time_plan``/``measure.time_fn``), so no timed loop runs
here.  Also the time limit, the race's errors, and the mirrored cases of
tests/test_measure.py, test_patient.py and test_exhaustive.py."""
import dataclasses
import hashlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu import plan as Rplan
from regent_fft_tpu.ops import factor as Rfactor
from regent_fft_tpu.ops import stockham as Rstockham
from regent_fft_tpu.utils import measure as Rmeasure
from regent_fft_tpu.utils import timing as Rtiming
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.ops import factor
from regent_fft_tpu_torch.utils import measure
from regent_fft_tpu_torch.utils import timing
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

KNOBS = ("REGENT_FFT_TAIL_MT", "REGENT_FFT_MXU_IMPL", "REGENT_FFT_F2_STRIPS")


def fake_seconds(name: str) -> float:
    """A deterministic 'time' for a candidate name."""
    return 1e-4 * (1 + int(hashlib.sha256(name.encode()).hexdigest()[:8],
                           16) % 997)


def _route_name(spec) -> str:
    return f"{spec.backend}|{spec.axis0_impl}|{spec.f2_impl}"


def install_fake_timers(monkeypatch):
    """Both packages time a candidate as fake_seconds of its name: a
    schedule by its radices, a plan core by its backend and routes, slow
    (1 s) under any JAX knob, so the defaults win the knob races."""
    def sched_time(build, *a, **k):
        return fake_seconds("sched " + " ".join(map(str, build)))

    monkeypatch.setattr(Rmeasure, "_schedule_step_fn",
                        lambda n, sched, sign, prec, use_3m: tuple(sched))
    monkeypatch.setattr(Rmeasure, "time_fn", sched_time)
    monkeypatch.setattr(measure, "_schedule_step_fn",
                        lambda n, sched, sign, use_3m: tuple(sched))
    monkeypatch.setattr(measure, "time_fn", sched_time)
    build = Rplan._build_core

    def tagged(spec):
        core = build(spec)
        core._fake_spec = spec
        return core
    monkeypatch.setattr(Rplan, "_build_core", tagged)

    def jax_chain(step, make_carry, *a, **k):
        if any(os.environ.get(kn) for kn in KNOBS):
            return 1.0
        return fake_seconds(_route_name(step._fake_spec))
    monkeypatch.setattr(Rtiming, "core_chain",
                        lambda core, spec, cdtype=None: (core, None))
    monkeypatch.setattr(Rtiming, "time_chain", jax_chain)
    monkeypatch.setattr(timing, "time_plan",
                        lambda plan, reps=10, seed=0:
                        fake_seconds(_route_name(plan.spec)))


def cpu_overrides() -> dict:
    """The port's schedule overrides, keyed as the JAX package keys them
    ((n, max_radix)); every one of them measured on the CPU."""
    assert {d for d, _, _ in factor._SCHEDULE_OVERRIDES} <= {"cpu"}
    return {(n, mr): f for (_, n, mr), f in factor._SCHEDULE_OVERRIDES.items()}


@pytest.fixture(autouse=True)
def _clean():
    # before as well as after: a JAX test file earlier in the same
    # worker may have left plans and winners in the JAX tables
    rt.cleanup()
    R.cleanup()
    Rstockham.schedule_description.cache_clear()
    yield
    rt.cleanup()
    R.cleanup()
    Rstockham.schedule_description.cache_clear()


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _lines(p):
    return [ln.strip() for ln in p.describe().splitlines()[1:-1]]


def _plan_pair(shape, planner, dtype="complex64", backend="auto",
               kind="c2c", axes=None):
    axes = tuple(range(len(shape))) if axes is None else axes
    jk = {"c2c": R.Kind.C2C, "r2c": R.Kind.R2C, "c2r": R.Kind.C2R}[kind]
    tk = {"c2c": rt.Kind.C2C, "r2c": rt.Kind.R2C, "c2r": rt.Kind.C2R}[kind]
    jd = R.BACKWARD if kind == "c2r" else R.FORWARD
    td = rt.BACKWARD if kind == "c2r" else rt.FORWARD
    jp = R.make_plan(shape, axes=axes, kind=jk, direction=jd, dtype=dtype,
                     backend=backend, planner=planner)
    tp = rt.make_plan(shape, axes=axes, kind=tk, direction=td, dtype=dtype,
                      backend=backend, planner=planner, device="cpu")
    return jp, tp


RACE_CASES = [((4, 16, 16), "complex64", "stockham"),
              ((2, 64, 128), "complex64", "stockham"),
              ((2, 8, 8, 8), "complex64", "stockham"),
              ((4, 16, 16), "complex32", "stockham"),
              ((4, 16, 16), "complex64", "auto"),
              ((2, 8, 8, 8), "complex64", "auto")]


@pytest.mark.parametrize("planner", ["measure", "patient", "exhaustive"])
@pytest.mark.parametrize("shape,dtype,backend", RACE_CASES)
def test_races_match_jax_under_the_same_timings(monkeypatch, shape, dtype,
                                                backend, planner):
    install_fake_timers(monkeypatch)
    jp, tp = _plan_pair(shape, planner, dtype, backend)
    jm, tm = jp.measurements, tp.measurements
    assert set(tm) == set(jm)
    for key in jm:
        if key in ("patient", "exhaustive", "backend"):
            continue
        assert tm[key]["winner"] == jm[key]["winner"]
        assert tm[key]["timings"] == jm[key]["timings"]
    if "backend" in jm:
        assert tm["backend"] == jm["backend"] == {
            "winner": "xla", "timings": {"xla": fake_seconds(
                _route_name(dataclasses.replace(tp.spec, backend="xla")))}}
    if planner in ("patient", "exhaustive"):
        jw, tw = jm[planner]["winner"], tm[planner]["winner"]
        assert tw == jw
        jt, tt = jm[planner]["timings"], tm[planner]["timings"]
        if planner == "patient":
            assert tt == jt
        else:
            assert tt["patient"] == jt["patient"]
            # the JAX grid names; the port times the defaults alone
            names = [measure.knob_name(c) for c in measure.knob_combos(
                tp.spec, tplan._build_core(dataclasses.replace(
                    tp.spec, planner="estimate", axis0_impl=tw["axis0_impl"],
                    f2_impl=tw["f2_impl"], backend=tw["backend"])).steps)]
            assert names == list(jt["knobs"])
            assert tt["knobs"] == {"defaults": jt["knobs"]["defaults"]}
            assert tw["knobs"] == {} == tp.knobs
        if shape == (2, 64, 128):          # a fused pair: all 12 routes
            assert len(tt if planner == "patient" else tt["patient"]) == 12
    assert cpu_overrides() == Rfactor._SCHEDULE_OVERRIDES
    assert _lines(tp) == _lines(jp)
    x = _crand(shape, 1)
    n = tp.spec.logical_n
    assert rel_l2(tp(x), to_numpy_complex(jp(x))) <= tolerance(n, dtype)


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("n", [64, 640, 1000, 1024, 4096, 65536])
def test_measure_schedule_matches_jax(monkeypatch, n, deep):
    install_fake_timers(monkeypatch)
    assert measure.candidate_schedules(n, deep=deep) == \
        Rmeasure.candidate_schedules(n, deep=deep)
    w, t = measure.measure_schedule(n, batch=8, deep=deep, device="cpu")
    jw, jt = Rmeasure.measure_schedule(n, batch=8, deep=deep)
    assert (w, t) == (jw, jt)
    assert cpu_overrides() == Rfactor._SCHEDULE_OVERRIDES == {(n, 128): w}


@pytest.mark.parametrize("kind,shape,axes", [
    ("r2c", (8, 64), (0, 1)), ("c2r", (4, 32), (1,)),
    ("r2c", (2, 16, 32), (1, 2))])
def test_measure_real_plans_match_jax(monkeypatch, kind, shape, axes):
    """Counterpart: test_measure.py's R2C/C2R cases."""
    install_fake_timers(monkeypatch)
    jp, tp = _plan_pair(shape, "measure", kind=kind, axes=axes,
                        backend="auto")
    assert tp.measurements == jp.measurements
    assert _lines(tp) == _lines(jp)
    rng = np.random.default_rng(7)
    if kind == "r2c":
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        hs = list(shape)
        hs[axes[-1]] = hs[axes[-1]] // 2 + 1
        x = _crand(tuple(hs), 8)
    assert rel_l2(tp(x), to_numpy_complex(jp(x))) \
        <= tolerance(tp.spec.logical_n)


def test_cached_winners_are_reused(monkeypatch):
    install_fake_timers(monkeypatch)
    spec = dict(shape=(4, 16, 16), backend="stockham", device="cpu")
    for planner in ("patient", "exhaustive"):
        p = rt.make_plan(spec["shape"], backend="stockham", device="cpu",
                         planner=planner)
        assert isinstance(p.measurements[planner]["timings"], dict)
        rt.destroy_plan(p)
        p2 = rt.make_plan(spec["shape"], backend="stockham", device="cpu",
                          planner=planner)
        assert p2.measurements[planner]["timings"] == "cached-wisdom"
    p = rt.make_plan((8, 64), axes=(0, 1), kind=rt.Kind.R2C, device="cpu",
                     planner="measure")
    rt.clear_plan_cache()
    p2 = rt.make_plan((8, 64), axes=(0, 1), kind=rt.Kind.R2C, device="cpu",
                      planner="measure")
    assert p2.measurements["backend"]["timings"] == "cached-wisdom"
    assert p.measurements["backend"]["winner"] == "xla"


def test_backend_wisdom_steers_auto_plans_of_its_device_type_only():
    shape = (4, 16, 16)
    cpu = rt.make_plan(shape, device="cpu")
    assert cpu.backend == "xla"
    key = tplan._backend_key(cpu.spec)
    assert key.device == "cpu" and key.planner == "estimate"
    tplan._BACKEND_WISDOM[key] = "stockham"
    rt.clear_plan_cache()
    steered = rt.make_plan(shape, device="cpu")
    assert steered.backend == "stockham"
    assert all(k == "stockham" for k, _, _ in steered.steps)
    cuda_key = tplan._backend_key(dataclasses.replace(cpu.spec,
                                                      device="cuda"))
    assert cuda_key != key and cuda_key.device == "cuda"
    assert tplan._backend_key(dataclasses.replace(
        cpu.spec, device="cuda:1")) == cuda_key
    x = _crand(shape, 2)
    assert rel_l2(steered(x), cpu(x)) <= tolerance(x.size)


def test_backend_candidates_keep_the_jax_gate():
    def spec(shape, axes, device="cuda", kind=rt.Kind.C2C):
        return tplan.PlanSpec(shape=shape, axes=axes, kind=kind,
                              direction=rt.FORWARD, device=device)
    assert measure.backend_candidates(spec((64, 1024), (1,), "cpu")) == ["xla"]
    assert measure.backend_candidates(spec((64, 1024), (1,))) == \
        ["xla", "stockham", "pallas", "hybrid"]
    # the kernel backends keep the JAX gate; "hybrid", the estimate
    # plan's backend on the card, is raced on every CUDA plan
    assert measure.backend_candidates(spec((4, 1 << 20), (1,))) == \
        ["xla", "hybrid"]
    assert measure.backend_candidates(spec((4, 64, 64, 64), (1, 2, 3),
                                           kind=rt.Kind.R2C)) == \
        ["xla", "stockham", "pallas", "hybrid"]
    assert measure.backend_candidates(spec((640, 64), (0, 1))) == \
        ["xla", "hybrid"]
    assert measure.backend_candidates(spec((64, 640), (1,), "cuda:1")) == \
        ["xla", "hybrid"]


def test_measure_race_on_the_card_keeps_the_estimate_route(monkeypatch):
    """A measure race on a CUDA plan times the hybrid, the estimate plan's
    backend there, beside "xla", so the winner it stores has beaten the
    estimate route: on 64 x 2^20 (the kernels' four-step) an estimate plan
    made after the race keeps the hybrid.  Fake times, a fake plan core."""
    spec = tplan.PlanSpec(shape=(64, 1 << 20), axes=(1,), kind=rt.Kind.C2C,
                          direction=rt.FORWARD, device="cuda",
                          planner="measure")
    estimate = dataclasses.replace(spec, planner="estimate")
    assert tplan._auto_backend(estimate) == "hybrid"
    times = {"xla": 13.75e-3, "hybrid": 2.78e-3}
    built = []

    def fake_core(s, switches=None):
        built.append(s.backend)
        return types.SimpleNamespace(spec=s)
    monkeypatch.setattr(measure, "measure_plan_sizes",
                        lambda s, deep=False: {})
    monkeypatch.setattr(measure, "_prepare", lambda device: None)
    monkeypatch.setattr(tplan, "_build_core", fake_core)
    monkeypatch.setattr(timing, "time_plan",
                        lambda plan, reps=10, seed=0: times[plan.spec.backend])
    plan = types.SimpleNamespace(switches=tplan.Switches(), measurements={},
                                 knobs={})
    raced = tplan.Plan._race(plan, spec)
    assert built == ["xla", "hybrid"]
    assert plan.measurements["backend"] == {"winner": "hybrid",
                                            "timings": times}
    assert raced.backend == "hybrid"
    assert tplan._BACKEND_WISDOM == {tplan._backend_key(spec): "hybrid"}
    assert tplan._auto_backend(estimate) == "hybrid"
    # a CPU plan of the same spec is not steered by the card's winner
    assert tplan._auto_backend(dataclasses.replace(estimate,
                                                   device="cpu")) == "xla"


def test_cpu_schedule_race_leaves_cuda_plan_steps_unchanged(monkeypatch):
    """A schedule measured on the CPU is installed for CPU plans only: a
    CUDA plan's contraction steps, step lines and factor plans stay the
    estimate's."""
    def step(n, device):
        s = tplan.PlanSpec(shape=(8, n), axes=(1,), kind=rt.Kind.C2C,
                           direction=rt.FORWARD, backend="xla",
                           device=device)
        steps = tplan.axis_steps(s, "xla", [1], False, torch.device(device))
        return [(k, a, arg if k != "general" else None)
                for k, a, arg in steps], [tplan.STEPS[k].name(s, a, arg)
                                          for k, a, arg in steps]
    n = 1000
    cuda_before = step(n, "cuda")
    factors_before = factor.plan_factors(n, device="cuda")
    monkeypatch.setattr(measure, "time_fn", lambda build, *a, **k: (
        1e-4 if build == (10, 10, 10) else 1e-3))
    monkeypatch.setattr(measure, "_schedule_step_fn",
                        lambda n, sched, sign, use_3m: tuple(sched))
    w, _ = measure.measure_schedule(n, batch=8, deep=True, device="cpu")
    assert w == (10, 10, 10)
    assert cpu_overrides() == {(n, 128): w}
    assert factor.schedule_override(n, device="cuda") is None
    assert factor.plan_factors(n, device="cuda") == factors_before
    assert factor.plan_factors(n, device="cpu") == ("mixed", w)
    assert step(n, "cuda") == cuda_before
    assert step(n, "cpu")[1] == ["1d-pipeline[mixed(1000 = 10*10*10): "
                                 "radix-10 -> radix-10 -> radix-10]"]
    # a small length is a direct step on the card, whatever the CPU pinned
    factor.set_schedule_override(96, (12, 8), device="cpu")
    assert factor.plan_factors(96, device="cuda") == ("direct", 96)
    assert factor.plan_factors(96, device=None) == ("mixed", (12, 8))


def test_patient_candidates_pruned_without_kernel_steps(monkeypatch):
    """Counterpart: test_patient.py."""
    install_fake_timers(monkeypatch)
    s = tplan.PlanSpec(shape=(2048,), axes=(0,), kind=rt.Kind.C2C,
                       direction=rt.FORWARD, backend="xla", device="cpu")
    winner, timings = measure.measure_patient(s, tplan._build_core)
    assert list(timings) == ["axis0=auto f2=auto"]
    assert winner == {"axis0_impl": "auto", "f2_impl": "auto",
                      "backend": "xla"}


def test_knob_grid_names_match_jax():
    """The port's knob grid is the JAX package's (measure.py:466-478)."""
    for shape, dtype in (((4, 16, 16), "complex64"), ((64,), "complex64"),
                         ((4, 64, 64), "complex32")):
        spec = tplan.PlanSpec(shape=shape, axes=tuple(range(len(shape))),
                              kind=rt.Kind.C2C, direction=rt.FORWARD,
                              dtype=dtype, backend="stockham", device="cpu")
        steps = tplan._build_core(spec).steps
        names = [measure.knob_name(c)
                 for c in measure.knob_combos(spec, steps)]
        assert names[0] == "defaults"
        want = ["mxu_impl=direct", "mxu_impl=fstw"] if dtype == "complex32" \
            else ["tail_mt=32", "tail_mt=64"]
        assert names[1:3] == want
        assert any("f2_strips" in nm for nm in names) == any(
            k == "stockham2" for k, _, _ in steps)
    assert measure.RACED_KNOBS == frozenset()


def test_timelimit_never_settles_on_a_failed_candidate(monkeypatch):
    """Counterpart: test_measure.py: with a zero cap and a first candidate
    the route refuses at build, the race goes on to a finite time."""
    calls = {"n": 0}
    monkeypatch.setattr(measure, "time_fn",
                        lambda build, *a, **k: fake_seconds(str(build)))
    real = measure._schedule_step_fn

    def refusing(*a):
        calls["n"] += 1
        if calls["n"] == 1:
            raise NotImplementedError("refused at build")
        return real(*a)
    monkeypatch.setattr(measure, "_schedule_step_fn", refusing)
    rt.set_timelimit(0.0)
    try:
        winner, timings = measure.measure_schedule(64, batch=8, install=False,
                                                   device="cpu")
    finally:
        rt.set_timelimit(measure.NO_TIMELIMIT)
    assert list(timings.values())[0] == float("inf")
    assert len(timings) == 2
    assert timings[" ".join(map(str, winner))] != float("inf")


def test_set_timelimit_caps_candidate_racing(monkeypatch):
    monkeypatch.setattr(measure, "time_fn",
                        lambda build, *a, **k: fake_seconds(str(build)))
    assert rt.get_timelimit() == measure.NO_TIMELIMIT
    rt.set_timelimit(0.0)
    try:
        _, timings = measure.measure_schedule(64, batch=8, install=False,
                                              device="cpu")
        assert len(timings) == 1
    finally:
        rt.set_timelimit(measure.NO_TIMELIMIT)
    _, timings = measure.measure_schedule(64, batch=8, install=False,
                                          device="cpu")
    assert len(timings) > 1


def test_run_errors_propagate_and_build_refusals_record_inf(monkeypatch):
    spec = tplan.PlanSpec(shape=(2, 64, 128), axes=(0, 1, 2),
                          kind=rt.Kind.C2C, direction=rt.FORWARD,
                          backend="stockham", device="cpu")

    def failing_run(plan, reps=10, seed=0):
        raise RuntimeError("CUDA launch failed")
    monkeypatch.setattr(timing, "time_plan", failing_run)
    with pytest.raises(RuntimeError, match="launch failed"):
        measure.measure_patient(spec, tplan._build_core)
    with pytest.raises(RuntimeError, match="launch failed"):
        measure.measure_backends(spec, tplan._build_core)

    monkeypatch.setattr(timing, "time_plan",
                        lambda plan, reps=10, seed=0:
                        fake_seconds(_route_name(plan.spec)))

    def refusing(s):
        if s.axis0_impl == "dma":
            raise NotImplementedError("route refused")
        if s.f2_impl == "ring" and s.axis0_impl == "grid":
            raise ValueError("gate")
        return tplan._build_core(s)
    winner, timings = measure.measure_patient(spec, refusing)
    assert len(timings) == 12
    inf = {k for k, v in timings.items() if v == float("inf")}
    assert inf == {"axis0=dma f2=auto", "axis0=dma f2=ring",
                   "axis0=dma f2=off", "axis0=grid f2=ring"}
    assert winner["axis0_impl"] != "dma"

    def broken(s):
        raise KeyError("not a refusal")
    with pytest.raises(KeyError):
        measure.measure_patient(spec, broken)


def test_races_time_with_the_port_timer_on_the_cpu():
    """One real race, unfaked: the port's timer on the CPU plans."""
    p = rt.make_plan((4, 32, 32), device="cpu", planner="exhaustive",
                     backend="stockham")
    m = p.measurements
    assert set(m) == {32, 4, "exhaustive"}
    for t in (m[32]["timings"], m["exhaustive"]["timings"]["patient"],
              m["exhaustive"]["timings"]["knobs"]):
        assert all(0 < v < float("inf") for v in t.values())
    x = _crand((4, 32, 32), 3)
    assert rel_l2(p(x), np.fft.fftn(x.astype(np.complex128))) \
        <= tolerance(x.size)


def test_malformed_timelimit_env_does_not_break_import():
    r = subprocess.run(
        [sys.executable, "-c",
         "import regent_fft_tpu_torch as rt; print(rt.get_timelimit())"],
        env={**os.environ, "REGENT_FFT_TIMELIMIT": "banana"},
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "-1.0"
    r = subprocess.run(
        [sys.executable, "-c",
         "import regent_fft_tpu_torch as rt; print(rt.get_timelimit())"],
        env={**os.environ, "REGENT_FFT_TIMELIMIT": "2.5"},
        capture_output=True, text=True, timeout=240)
    assert r.stdout.strip() == "2.5"


def test_deep_schedule_space_is_wider():
    """Counterpart: test_exhaustive.py."""
    shallow = measure.candidate_schedules(1024)
    deep = measure.candidate_schedules(1024, deep=True)
    assert set(shallow) <= set(deep) and len(deep) > len(shallow)
    assert any(len(s) == 2 and s[0] < s[1] for s in deep)
    assert any(len(s) == 3 for s in deep)
    assert (128, 8) in shallow and (32, 32) in shallow
    assert all(int(np.prod(s)) == 1024 for s in deep)


def test_planner_value_and_impls_validate():
    with pytest.raises(ValueError):
        rt.make_plan((8, 8), device="cpu", planner="bogus")
    with pytest.raises(ValueError):
        rt.make_plan((8, 8), device="cpu", axis0_impl="bogus")
    with pytest.raises(ValueError):
        rt.make_plan((8, 8), device="cpu", f2_impl="bogus")
