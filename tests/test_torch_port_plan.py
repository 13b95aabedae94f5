"""The port's complex64 C2C plans (device="cpu") against the JAX package's
plans on the same inputs: results within tolerance(logical_n), the same
describe() step lines, the plan lifecycle and the numpy-style API."""
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import Norm as JNorm
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm, SplitComplex
from regent_fft_tpu_torch.utils.verify import (check_impulse, check_linearity,
                                               check_shift, rel_l2, tolerance)

SHAPES = [(8, 1024), (2, 256, 256), (4, 128, 256), (384, 8, 128)]


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _plans(shape, direction, norm, backend, axes=None):
    axes = tuple(range(len(shape))) if axes is None else axes
    jp = R.make_plan(shape, axes=axes, kind=JKind.C2C,
                     direction=JDirection(int(direction)),
                     norm=JNorm(norm.value), backend=backend)
    tp = rt.make_plan(shape, axes=axes, kind=Kind.C2C, direction=direction,
                      norm=norm, backend=backend, device="cpu")
    return jp, tp


def _step_lines(text):
    return [ln.strip() for ln in text.splitlines() if ln.startswith("  (axis")]


def _np_ref(x, axes, direction, scale):
    x = x.astype(np.complex128)
    if direction == Direction.FORWARD:
        return np.fft.fftn(x, axes=axes) * scale
    return np.fft.ifftn(x, axes=axes, norm="forward") * scale


@pytest.mark.parametrize("norm", list(Norm))
@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.BACKWARD])
@pytest.mark.parametrize("shape", SHAPES)
def test_stockham_plan_matches_jax(shape, direction, norm):
    x = _crand(shape, 7)
    jp, tp = _plans(shape, direction, norm, "stockham")
    yj = to_numpy_complex(jp(x))
    y = tp(x)
    assert y.dtype == torch.complex64 and y.device.type == "cpu"
    assert tuple(y.shape) == shape
    n = tp.spec.logical_n
    tol = tolerance(n)
    ref = _np_ref(x, tp.spec.axes, direction, rt.plan._norm_scale(tp.spec))
    assert rel_l2(y, yj) <= tol
    assert rel_l2(y, ref) <= tol
    assert rel_l2(yj, ref) <= tol
    back = tp.inverse()(y)
    assert rel_l2(back, x) <= tol


@pytest.mark.parametrize("shape", SHAPES)
def test_describe_step_lines_match_jax(shape):
    jp, tp = _plans(shape, Direction.FORWARD, Norm.BACKWARD, "stockham")
    lines = _step_lines(tp.describe())
    assert lines == _step_lines(jp.describe())
    assert all("kernel" in ln for ln in lines)


def test_main_path_step_lists():
    """The shapes the chip run drives: the 3-D north star is one fused pair
    plus one leading-axis butterfly; 1-D batched is one last-axis pass."""
    def f(shape, axes):
        return _step_lines(rt.make_plan(shape, axes=axes, backend="stockham",
                                        device="cpu").describe())
    assert f((512, 512, 512), (0, 1, 2)) == [
        "(axis 1: kernel-fused2(512, 512))",
        "(axis 0: kernel-butterfly(n=512))"]
    assert f((16, 512, 512), (1, 2)) == ["(axis 1: kernel-fused2(512, 512))"]
    assert f((4096, 1024), (1,)) == ["(axis 1: kernel-butterfly(n=1024))"]
    assert f((4096, 640), (1,)) == ["(axis 1: kernel-butterfly(n=640))"]


@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.BACKWARD])
@pytest.mark.parametrize("shape,axes", [((5, 24), (1,)), ((24,), (0,)),
                                        ((1000,), (0,)), ((3, 1000), (1,)),
                                        ((6, 24, 16), (0, 1, 2))])
def test_auto_backend_cpu_matches_jax(shape, axes, direction):
    x = _crand(shape, 11)
    jp, tp = _plans(shape, direction, Norm.ORTHO, "auto", axes)
    assert tp.backend == "xla"
    assert _step_lines(tp.describe()) == _step_lines(jp.describe())
    tol = tolerance(tp.spec.logical_n)
    assert rel_l2(tp(x), to_numpy_complex(jp(x))) <= tol
    assert rel_l2(tp(x), _np_ref(x, axes, direction,
                                 rt.plan._norm_scale(tp.spec))) <= tol


def test_api_wrappers_match_numpy():
    x = _crand((4, 32, 64), 3)
    tol = tolerance(32 * 64 * 4)
    assert rel_l2(rt.fftn(x, device="cpu"), np.fft.fftn(x)) <= tol
    assert rel_l2(rt.ifftn(x, device="cpu"), np.fft.ifftn(x)) <= tol
    assert rel_l2(rt.fft2(x, device="cpu", norm="ortho"),
                  np.fft.fft2(x, norm="ortho")) <= tol
    assert rel_l2(rt.ifft2(x, device="cpu"), np.fft.ifft2(x)) <= tol
    assert rel_l2(rt.fft(x, n=48, axis=1, device="cpu"),
                  np.fft.fft(x, n=48, axis=1)) <= tol
    assert rel_l2(rt.ifft(x, n=16, device="cpu"), np.fft.ifft(x, n=16)) <= tol
    t = torch.from_numpy(x)
    assert rel_l2(rt.fftn(t, s=(16, 80), device="cpu"),
                  np.fft.fftn(x, s=(16, 80), axes=(1, 2))) <= tol
    # a SplitComplex is a complex32 plan, as in the JAX package
    # (api.py:36-37): bf16 planes in and out, held at the complex32 bound
    split = SplitComplex(t.real.contiguous(), t.imag.contiguous())
    ys = rt.fft(split, backend="stockham", device="cpu")
    assert isinstance(ys, SplitComplex) and ys.re.dtype == torch.bfloat16
    assert rel_l2(ys, np.fft.fft(x)) <= tolerance(64, "complex32")


def test_verify_harness_on_port():
    fn = lambda v: rt.fft(v, backend="stockham", device="cpu")
    tol = tolerance(256)
    assert check_impulse(fn, 256, j=3) <= tol
    assert check_linearity(fn, 256) <= tol
    assert check_shift(fn, 256, s=5) <= tol


def test_plan_cache_and_lifecycle():
    rt.clear_plan_cache()
    spec = rt.PlanSpec(shape=(4, 64), axes=(1,), kind=Kind.C2C,
                       direction=Direction.FORWARD, device="cpu")
    p = rt.make_plan(spec)
    assert rt.make_plan(spec) is p and p in rt.cached_plans()
    assert rt.execute_plan(p, _crand((4, 64), 0)).shape == (4, 64)
    rt.destroy_plan(p)
    assert p not in rt.cached_plans()
    with pytest.raises(RuntimeError):
        p(_crand((4, 64), 0))
    q = rt.make_plan(spec)
    assert q is not p and q(_crand((4, 64), 0)).shape == (4, 64)
    with pytest.raises(ValueError):
        q(_crand((4, 32), 0))
    rt.clear_plan_cache()
    assert rt.cached_plans() == []


def test_spec_from_jax_maps_fields():
    js = R.PlanSpec(shape=(2, 256, 256), axes=(1, 2), kind=JKind.C2C,
                    direction=JDirection.BACKWARD, norm=JNorm.ORTHO,
                    backend="stockham")
    ts = rt.spec_from_jax(js, device="cpu")
    assert ts.device == "cpu"
    assert (ts.kind, ts.direction, ts.norm) == (Kind.C2C, Direction.BACKWARD,
                                                Norm.ORTHO)
    for f in ("shape", "axes", "dtype", "precision", "use_3m", "max_radix",
              "backend", "planner", "axis0_impl", "f2_impl", "xla_direct_max"):
        assert getattr(ts, f) == getattr(js, f), f
    x = _crand((2, 256, 256), 5)
    assert rel_l2(rt.make_plan(ts)(x), to_numpy_complex(R.make_plan(js)(x))) \
        <= tolerance(256 * 256)


@pytest.mark.parametrize("kwargs", [
    dict(planner="patient"), dict(dtype="complex128", planner="model"),
    dict(planner="measure"),
])
def test_out_of_slice_options_raise(kwargs):
    # the planners but "estimate" raised before the port had Queue 1 #11;
    # they plan now (tests/test_torch_port_measure.py holds the races)
    p = rt.make_plan((4, 64), device="cpu", **kwargs)
    x = _crand((4, 64), 11)
    dt = kwargs.get("dtype", "complex64")
    assert rel_l2(p(x), np.fft.fftn(x.astype(np.complex128))) \
        <= tolerance(256, dt)
    rt.cleanup()


def test_out_of_slice_lengths_and_api_raise():
    # 2053 (prime, Rader) raised before the port had Queue 1 #8, and
    # planner="measure" before it had Queue 1 #11
    x53 = _crand((2053,), 3)
    assert rel_l2(rt.fft(x53, device="cpu"),
                  np.fft.fft(x53.astype(np.complex128))) <= tolerance(2053)
    p = rt.make_plan((2053,), planner="measure", device="cpu")
    assert p.measurements["backend"]["winner"] == "xla"
    assert rel_l2(p(x53), np.fft.fft(x53.astype(np.complex128))) \
        <= tolerance(2053)
    rt.cleanup()
    # float64 data plans complex128 (it raised before the port had it)
    import scipy.fft
    x = np.random.default_rng(2).standard_normal((8, 8))
    for fn in ("rfft", "rfftn", "rfft2", "ihfft", "ihfftn"):
        y = getattr(rt, fn)(x, device="cpu")
        assert y.dtype == torch.complex128
        assert rel_l2(y, getattr(scipy.fft, fn)(x)) \
            <= tolerance(64, "complex128")


def test_use_3m_and_unfused_pair_match():
    x = _crand((2, 128, 256), 9)
    ref = np.fft.fftn(x.astype(np.complex128))
    tol = tolerance(x.size)
    p3 = rt.make_plan(x.shape, use_3m=True, device="cpu")
    assert rel_l2(p3(x), ref) <= tol
    off = rt.make_plan(x.shape, backend="stockham", f2_impl="off", device="cpu")
    assert "kernel-fused2" not in off.describe()
    assert rel_l2(off(x), ref) <= tol


def test_schedule_override_and_apply_along_axis():
    from regent_fft_tpu_torch.ops import factor, nd
    from regent_fft_tpu_torch.ops import stockham as tstockham
    x = _crand((3, 96, 5), 4)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    factor.set_schedule_override(96, (12, 8), device="cpu")
    try:
        p = rt.make_plan((3, 96, 5), axes=(1,), device="cpu")
        assert _step_lines(p.describe()) == ["(axis 1: einsum-mixed2(96=12x8))"]
        assert rel_l2(p(x), ref) <= tolerance(96)
    finally:
        factor._SCHEDULE_OVERRIDES.clear()
        rt.clear_plan_cache()
    t = torch.from_numpy(x)
    y = nd.apply_along_axis(
        lambda a, b: tstockham.direct_dft_axis(a, b, -1, 96, -1), 1,
        t.real.contiguous(), t.imag.contiguous())
    assert rel_l2(torch.complex(*y), ref) <= tolerance(96)


def test_reference_dft_and_plan_log(caplog):
    import logging
    from regent_fft_tpu_torch.utils import plog
    from regent_fft_tpu_torch.utils.verify import reference_dft
    x = _crand((4, 32), 6)
    assert rel_l2(reference_dft(x, axes=(1,), sign=+1),
                  np.fft.ifft(x.astype(np.complex128), axis=1) * 32) <= 1e-12
    plog.set_log_level(2)
    try:
        with caplog.at_level(logging.DEBUG, logger="regent_fft_tpu_torch"):
            rt.clear_plan_cache()
            rt.make_plan((4, 32), device="cpu")
        assert "direct-einsum(n=32)" in caplog.text
    finally:
        plog.set_log_level(0)


def test_narrow_trailing_batch_matches_jax():
    """(…, 128, 4): the JAX package moves the batch to the front on this
    shape (plan.py:575-588); the port runs the steps in place."""
    shape = (16, 8, 128, 4)
    x = _crand(shape, 13)
    jp, tp = _plans(shape, Direction.FORWARD, Norm.BACKWARD, "stockham",
                    axes=(0, 1, 2))
    tol = tolerance(16 * 8 * 128)
    assert rel_l2(tp(x), to_numpy_complex(jp(x))) <= tol
    assert rel_l2(tp(x), np.fft.fftn(x.astype(np.complex128),
                                     axes=(0, 1, 2))) <= tol
