"""The port's native planner (``regent_fft_tpu_torch/native``), the "model"
schedule mode and ``Plan.cost`` against the JAX package's: the same
factorizations, schedules, smooth sizes, flops and modeled costs for every
n in 2..4096, under the default cost parameters and under calibrations
installed in both packages; "model" plans with the JAX plans' step lines
and outputs."""
import ctypes

import numpy as np
import pytest

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.native import planner as Rnative
from regent_fft_tpu.ops import factor as Rfactor
from regent_fft_tpu.utils import calibrate as Rcal

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.native import planner as native
from regent_fft_tpu_torch.ops import factor
from regent_fft_tpu_torch.ops import _build
from regent_fft_tpu_torch.utils import calibrate as cal
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

NS = range(2, 4097)
CALIBRATIONS = [
    dict(device="cal-a", mxu_tflops=50.0, vpu_gflops=700.0, hbm_gbps=3000.0,
         stage_overhead_s=8e-5),
    dict(device="cal-b", mxu_tflops=20.0, vpu_gflops=3000.0, hbm_gbps=500.0,
         stage_overhead_s=9e-6),
]


@pytest.fixture(autouse=True)
def _clean():
    # before as well as after: a JAX test file earlier in the same
    # worker may have left plans and winners in the JAX tables
    rt.cleanup()
    R.cleanup()
    yield
    rt.cleanup()
    R.cleanup()


def _jax_stage_flops(n, factors):
    arr = (ctypes.c_uint32 * len(factors))(*factors)
    return Rnative.load().rftp_stage_flops(n, arr, len(factors))


def _install(d):
    cal.install_calibration(cal.Calibration(**d))
    Rcal.install_calibration(Rcal.Calibration(**d))


def test_library_builds_beside_the_kernels():
    assert native.available()
    path = native.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert "regent_fft_tpu/native" not in str(path)
    assert native.version() == Rnative.load().rftp_version() == 4


@pytest.mark.parametrize("max_radix", [128, 16])
def test_factorize_and_next_fast_len_equal_for_every_n(max_radix):
    for n in NS:
        assert native.factorize(n, max_radix) == Rnative.factorize(n, max_radix)
        assert native.factorize(n, max_radix) == factor.factorize(n, max_radix)
        assert native.next_fast_len(n) == Rnative.next_fast_len(n)


@pytest.mark.parametrize("calibration", [None] + CALIBRATIONS)
@pytest.mark.parametrize("max_radix", [128, 16])
def test_schedule_flops_and_cost_equal_for_every_n(max_radix, calibration):
    if calibration is not None:
        _install(calibration)
    for n in NS:
        s = native.best_schedule(n, max_radix)
        assert s == Rnative.best_schedule(n, max_radix), n
        assert native.schedule_cost(n, max_radix) \
            == Rnative.schedule_cost(n, max_radix), n
        assert factor.schedule(n, max_radix, "model") \
            == Rfactor.schedule(n, max_radix, "model"), n
        assert factor.plan_factors(n, max_radix, "model") \
            == Rfactor.plan_factors(n, max_radix, "model"), n
        f = s or native.factorize(n, max_radix)
        if f:
            assert native.stage_flops(n, f) == _jax_stage_flops(n, f) \
                == factor.stage_flops(n, f)


def test_calibrations_steer_the_schedules():
    """The installed calibration reaches the port's library (the two
    calibrations above disagree somewhere, so the sweep tests something),
    and reset_calibration restores the defaults."""
    default = [native.best_schedule(n) for n in NS]
    picks = []
    for d in CALIBRATIONS:
        _install(d)
        picks.append([native.best_schedule(n) for n in NS])
    assert picks[0] != picks[1]
    cal.reset_calibration()
    assert [native.best_schedule(n) for n in NS] == default


def test_schedule_modes_and_override():
    """Counterpart: tests/test_native_planner.py's mode test."""
    assert factor.schedule(1024, mode="estimate") == factor.factorize(1024)
    assert factor.schedule(1024, mode="model") == (32, 32)
    assert factor.schedule(4096, mode="model") == (64, 64)
    assert factor.factorize(4096) == (128, 32)
    assert factor.schedule(640, 128, "model") == (80, 8)
    assert factor.schedule(1000, 128, "model") == (125, 8)
    factor.set_schedule_override(1024, (128, 8))
    assert factor.schedule(1024, mode="model") == (128, 8)
    assert factor.plan_factors(1024, mode="model")[1] == (128, 8)
    assert native.best_schedule(131) is None
    assert native.schedule_cost(131) is None


def _spec_pair(shape, axes, kind):
    JK = {"c2c": R.Kind.C2C, "r2c": R.Kind.R2C, "c2r": R.Kind.C2R}[kind]
    TK = {"c2c": rt.Kind.C2C, "r2c": rt.Kind.R2C, "c2r": rt.Kind.C2R}[kind]
    d = -1 if kind != "c2r" else 1
    jp = R.make_plan(shape, axes=axes, kind=JK, direction=JDirection(d))
    tp = rt.make_plan(shape, axes=axes, kind=TK, direction=rt.Direction(d),
                      device="cpu")
    return jp, tp


COST_SPECS = [((4096,), (0,)), ((6, 1000), (1,)), ((640, 96), (0, 1)),
              ((12, 60, 2048), (1, 2)), ((8, 12, 20), (0, 1, 2)),
              ((2, 131, 64), (1, 2)), ((2, 4, 1024, 16), (1, 2, 3))]


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
@pytest.mark.parametrize("shape,axes", COST_SPECS)
def test_plan_cost_equals_jax(shape, axes, kind):
    jp, tp = _spec_pair(shape, axes, kind)
    assert tp.cost() == jp.cost()
    if 131 in shape:
        assert tp.cost() == 0.0          # a length outside the model
    else:
        assert tp.cost() > 0.0
    _install(CALIBRATIONS[0])
    assert tp.cost() == jp.cost()


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("shape,axes", [((4, 1024), (1,)), ((3, 640), (1,)),
                                        ((2, 1000), (1,)),
                                        ((2, 600, 6), (1, 2))])
def test_model_plan_matches_jax(shape, axes):
    jp = R.make_plan(shape, axes=axes, kind=R.Kind.C2C, direction=R.FORWARD,
                     planner="model")
    tp = rt.make_plan(shape, axes=axes, device="cpu", planner="model")
    lines = [ln.strip() for ln in tp.describe().splitlines()[1:-1]]
    assert lines == [ln.strip() for ln in jp.describe().splitlines()[1:-1]]
    est = rt.make_plan(shape, axes=axes, device="cpu")
    assert any("mixed2" in ln for ln in lines)
    assert lines != [ln.strip() for ln in est.describe().splitlines()[1:-1]] \
        or shape == (4, 1024)
    x = _crand(shape, 3)
    n = tp.spec.logical_n
    assert rel_l2(tp(x), np.asarray(jp(x))) <= tolerance(n)
    assert rel_l2(tp(x), np.fft.fftn(x.astype(np.complex128), axes=axes)) \
        <= tolerance(n)


def test_model_general_step_takes_the_model_schedule(monkeypatch):
    """The 1-D pipeline takes the planner's schedule mode
    (stockham.build_c2c_1d's planner argument, as in the JAX package):
    1024 runs (32, 32) under "model", the greedy (128, 8) under
    "estimate"; a length with no two-factor split (20000) runs the
    greedy schedule in both modes, the cost model's fallback."""
    import torch
    from regent_fft_tpu_torch.ops import stockham
    seen = []
    real = stockham.mixed_radix_fft

    def spy(xr, xi, n, factors, sign, use_3m=False):
        seen.append(tuple(factors))
        return real(xr, xi, n, factors, sign, use_3m)
    monkeypatch.setattr(stockham, "mixed_radix_fft", spy)
    for n, mode, want in ((1024, "model", (32, 32)),
                          (1024, "estimate", (128, 8)),
                          (20000, "model", (125, 80, 2))):
        x = _crand((2, n), 4)
        fn = stockham.build_c2c_1d(n, rt.FORWARD, planner=mode)
        seen.clear()
        y = fn(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
        assert seen[0] == want
        assert rel_l2(torch.complex(*y), np.fft.fft(x.astype(np.complex128))) \
            <= tolerance(n)
    assert factor.schedule(20000, 128, "model") == factor.factorize(20000)
    x = _crand((2, 20000), 5)
    tp = rt.make_plan((2, 20000), axes=(1,), device="cpu", planner="model")
    jp = R.make_plan((2, 20000), axes=(1,), kind=R.Kind.C2C,
                     direction=R.FORWARD, planner="model")
    assert [ln.strip() for ln in tp.describe().splitlines()[1:-1]] == \
        [ln.strip() for ln in jp.describe().splitlines()[1:-1]]
    assert rel_l2(tp(x), np.asarray(jp(x))) <= tolerance(20000)
