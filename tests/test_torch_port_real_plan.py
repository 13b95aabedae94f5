"""The port's R2C and C2R plans (device="cpu") against the JAX package's
plans on the same inputs: results within tolerance(logical_n) of each other
and of numpy in float64, the inverse round trip, identical describe() step
lines (the real-axis line included), the Nyquist-packed layout, and the
plan routes the chip run takes at full size."""
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import Norm as JNorm
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm
from regent_fft_tpu_torch.plan import _norm_scale
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

# (shape, axes): kernel narrow, half-length, non-power-of-two einsum, odd n,
# Nyquist-packed rank 2, and a small copy of the 3-D main path
CASES = [((8, 1024), (1,)), ((6, 2048), (1,)), ((5, 30), (1,)),
         ((3, 31), (1,)), ((2, 64, 256), (1, 2)), ((2, 32, 32, 256), (1, 2, 3))]


def _lines(text):
    return [ln.strip() for ln in text.splitlines()[1:-1]]


def _plans(shape, axes, kind, norm, backend, **kw):
    d = Direction.FORWARD if kind == Kind.R2C else Direction.BACKWARD
    jp = R.make_plan(shape, axes=axes, kind=JKind(kind.value),
                     direction=JDirection(int(d)), norm=JNorm(norm.value),
                     backend=backend, **kw)
    tp = rt.make_plan(shape, axes=axes, kind=kind, direction=d, norm=norm,
                      backend=backend, device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("norm", list(Norm))
@pytest.mark.parametrize("backend", ["stockham", "xla"])
@pytest.mark.parametrize("shape,axes", CASES)
def test_real_plans_match_jax(shape, axes, backend, norm):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    jp, tp = _plans(shape, axes, Kind.R2C, norm, backend)
    n = tp.spec.logical_n
    tol = tolerance(n)
    y = tp(x)
    half = np.fft.rfftn(x.astype(np.float64), axes=axes)
    assert y.dtype == torch.complex64 and tuple(y.shape) == half.shape
    assert rel_l2(y, half * _norm_scale(tp.spec)) <= tol
    assert rel_l2(y, to_numpy_complex(jp(x))) <= tol
    assert _lines(tp.describe()) == _lines(jp.describe())
    assert _lines(tp.describe())[0].startswith(f"(real axis {axes[-1]}: ")
    # C2R on a half spectrum whose endpoint bins are not Hermitian: both
    # packages and numpy drop the same parts
    rng = np.random.default_rng(1)
    h = (half + rng.standard_normal(half.shape)).astype(np.complex64)
    ip, jip = tp.inverse(), jp.inverse()
    assert ip.spec.kind == Kind.C2R and jip.spec.kind == JKind.C2R
    z = ip(h)
    s = [shape[a] for a in axes]
    ref = np.fft.irfftn(h.astype(np.complex128), s=s, axes=axes,
                        norm="forward") * _norm_scale(ip.spec)
    assert z.dtype == torch.float32 and tuple(z.shape) == shape
    assert rel_l2(z, ref) <= tol
    assert rel_l2(z, np.asarray(jip(h))) <= tol
    assert _lines(ip.describe()) == _lines(jip.describe())
    assert _lines(ip.describe())[-1].startswith(f"(real axis {axes[-1]}: ")
    assert rel_l2(ip(y), x) <= tol                   # the round trip


@pytest.mark.parametrize("norm", [Norm.ORTHO, Norm.NONE])
def test_packed_layout_plans_match_jax(norm):
    """packed_layout=True: the R2C output and the C2R input stay in the
    (..., n/2) Nyquist-packed layout."""
    shape, axes = (2, 64, 256), (1, 2)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jp, tp = _plans(shape, axes, Kind.R2C, norm, "stockham",
                    packed_layout=True)
    tol = tolerance(tp.spec.logical_n)
    y = tp(x)
    assert tuple(y.shape) == (2, 64, 128)
    assert rel_l2(y, to_numpy_complex(jp(x))) <= tol
    assert _lines(tp.describe()) == _lines(jp.describe())
    ip, jip = tp.inverse(), jp.inverse()
    assert ip.spec.packed_layout
    assert rel_l2(ip(y), np.asarray(jip(to_numpy_complex(jp(x))))) <= tol
    assert rel_l2(ip(y), x) <= tol
    assert _lines(ip.describe()) == _lines(jip.describe())


@pytest.mark.parametrize("backend,shape", [("xla", (4, 512)),
                                           ("stockham", (4, 96))])
def test_packed_layout_needs_kernel_path(backend, shape):
    """Both packages refuse packed_layout off the kernel path: the XLA
    backend, a length the kernel does not take, and a 1-D C2R plan (the
    inverse of a 1-D packed R2C), which takes the half-length route."""
    for kind, d in ((Kind.R2C, Direction.FORWARD),
                    (Kind.C2R, Direction.BACKWARD)):
        with pytest.raises(ValueError, match="packed_layout"):
            rt.make_plan(shape, axes=(1,), kind=kind, direction=d,
                         packed_layout=True, backend=backend, device="cpu")
        with pytest.raises(ValueError, match="packed_layout"):
            R.make_plan(shape, axes=(1,), kind=JKind(kind.value),
                        direction=JDirection(int(d)), packed_layout=True,
                        backend=backend)
    p = rt.make_plan((4, 512), axes=(1,), kind=Kind.R2C, packed_layout=True,
                     backend="stockham", device="cpu")
    with pytest.raises(ValueError, match="packed_layout"):
        p.inverse()


def test_packed_layout_c2c_raises_in_both_packages():
    """A C2C spec with packed_layout=True is refused by both packages."""
    with pytest.raises(ValueError, match="R2C/C2R plans only"):
        rt.PlanSpec(shape=(4, 256), axes=(1,), kind=Kind.C2C,
                    direction=Direction.FORWARD, packed_layout=True)
    with pytest.raises(ValueError, match="R2C/C2R plans only"):
        R.PlanSpec(shape=(4, 256), axes=(1,), kind=JKind.C2C,
                   direction=JDirection.FORWARD, packed_layout=True)


def test_main_path_real_step_lists():
    """The routes of the chip run's four real plans, at full size (made,
    not run): the row-pair kernel for 1-D R2C, the half-length core for 1-D
    C2R, and Nyquist-packed mid-axis butterflies for 3-D."""
    def f(shape, axes, kind):
        d = Direction.FORWARD if kind == Kind.R2C else Direction.BACKWARD
        return _lines(rt.make_plan(shape, axes=axes, kind=kind, direction=d,
                                   backend="stockham",
                                   device="cpu").describe())
    assert f((4096, 1024), (1,), Kind.R2C) == [
        "(real axis 1: n=1024 shared-head row-pair kernel r2c)"]
    assert f((4096, 1024), (1,), Kind.C2R) == [
        "(real axis 1: n=1024 half-length conjugate-even kernel c2r)"]
    three = ["(axis 2: kernel-butterfly(n=256))",
             "(axis 1: kernel-butterfly(n=256))"]
    assert f((4, 256, 256, 256), (1, 2, 3), Kind.R2C) == [
        "(real axis 3: n=256 shared-head row-pair kernel r2c "
        "[nyquist-packed mids])"] + three
    assert f((4, 256, 256, 256), (1, 2, 3), Kind.C2R) == three + [
        "(real axis 3: n=256 fused kernel c2r [nyquist-packed mids])"]


def test_real_plan_accounting_matches_jax():
    for kind in (Kind.R2C, Kind.C2R):
        for shape, axes in CASES[:5]:
            jp, tp = _plans(shape, axes, kind, Norm.BACKWARD, "xla")
            assert tp.flops == jp.flops
            assert tp.algorithm_flops == jp.algorithm_flops
            assert tp.bytes_ideal == jp.bytes_ideal


def test_real_plan_inputs():
    p = rt.make_plan((4, 64), axes=(1,), kind=Kind.R2C, device="cpu")
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64))
    tol = tolerance(64)
    assert rel_l2(p(torch.from_numpy(x)), ref) <= tol
    assert rel_l2(p(rt.SplitComplex(torch.from_numpy(x), torch.zeros(4, 64))),
                  ref) <= tol
    with pytest.raises(ValueError):
        p(x[:, :32])
    with pytest.raises(TypeError):
        p(x.astype(np.complex64))
    with pytest.raises(TypeError):
        p.execute_split(torch.from_numpy(x), torch.from_numpy(x))
    q = p.inverse()
    with pytest.raises(ValueError):
        q(ref[:, :32])
    with pytest.raises(TypeError):
        q.execute_real(torch.from_numpy(x))
