"""The gap-fused pass (``fft_axes_gap_stockham``, plan step ``stockham_gap``)
in the port against the JAX package on the CPU.

The port's CPU planes run ``fft_axes_gap_plain``; the JAX side runs
``_runner_fused2_gap`` in interpret mode.  Inputs are made with numpy from
a seed (rounded to bf16 once for the bf16 cases, so both packages and the
float64 reference see the same values).  Bound: ``tolerance(n, dtype)``
between the packages and for each against numpy in float64, n the
product of the transformed lengths.  The plans take the route only under
``REGENT_FFT_GAP_FUSED=1``, read when a plan is built, so every plan test
sets it with monkeypatch and clears both plan caches around it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import Norm as JNorm
from regent_fft_tpu.dtypes import SplitComplex as JSplit
from regent_fft_tpu.ops import pallas_stockham as jps
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Norm, SplitComplex
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

DTYPES = {"complex64": (torch.float32, jnp.float32),
          "complex32": (torch.bfloat16, jnp.bfloat16)}


def _planes(shape, seed, dtype):
    """(torch planes, jax planes, the complex128 of the exact values)."""
    rng = np.random.default_rng(seed)
    td, jd = DTYPES[dtype]
    tr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(td)
    ti = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(td)
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    return ((tr, ti), (jnp.asarray(tr.float().numpy(), jd),
                       jnp.asarray(ti.float().numpy(), jd)), xd)


def _lines(text):
    return [ln.strip() for ln in text.splitlines() if ln.startswith("  (axis")]


def _ref(xd, axes, sign, scale):
    y = (np.fft.fftn(xd, axes=axes) if sign < 0
         else np.fft.ifftn(xd, axes=axes, norm="forward"))
    return y * scale


# --- the gate and the entry ---------------------------------------------------
def test_fused_gap_gate_equal():
    ns = [8, 12, 16, 24, 64, 96, 128, 160, 256, 384, 512, 640, 1024, 2048,
          4096]
    for n1 in ns:
        for n2 in ns:
            assert (sk.fused_gap_supported(n1, n2)
                    == jps.fused_gap_supported(n1, n2)), (n1, n2)


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
@pytest.mark.parametrize("shape,direction,scale", [
    ((16, 2, 128), Direction.FORWARD, 1.0),
    ((2, 32, 3, 256), Direction.FORWARD, 1.0),
    ((128, 4, 128), Direction.BACKWARD, 1.0 / (128 * 128)),
])
def test_gap_entry_matches_jax(shape, direction, scale, dtype):
    (tr, ti), (jr, ji), xd = _planes(shape, 3, dtype)
    before = dict(sk.LAUNCHES)
    yr, yi = sk.fft_axes_gap_stockham(tr, ti, direction, scale)
    assert sk.LAUNCHES == before            # CPU planes launch nothing
    zr, zi = jps.fft_axes_gap_stockham(jr, ji, JDirection(int(direction)),
                                       scale, interpret=True)
    assert yr.dtype == yi.dtype == DTYPES[dtype][0]
    assert zr.dtype == DTYPES[dtype][1]
    assert tuple(yr.shape) == shape
    n = shape[-3] * shape[-1]
    tol = tolerance(n, dtype)
    y = SplitComplex(yr, yi)
    jy = to_numpy_complex(JSplit(zr, zi))
    ref = _ref(xd, (-3, -1), int(direction), scale)
    assert rel_l2(y, jy) <= tol
    assert rel_l2(y, ref) <= tol
    assert rel_l2(jy, ref) <= tol


def test_gap_plain_is_the_two_axis_dft():
    """The plain version alone, both signs, against numpy in float64: the
    (z, x) DFT of every (b, y) block, the intermediate kept in f32."""
    (tr, ti), _, xd = _planes((3, 64, 5, 384), 4, "complex64")
    for sign in (-1, 1):
        yr, yi = sk.fft_axes_gap_plain(tr, ti, sign, 0.5)
        assert yr.is_contiguous() and yr.dtype == torch.float32
        assert rel_l2(SplitComplex(yr, yi), _ref(xd, (1, 3), sign, 0.5)) \
            <= tolerance(64 * 384)


def test_gap_entry_raises_as_jax():
    z = torch.zeros
    with pytest.raises(ValueError, match="rank >= 3"):
        sk.fft_axes_gap_stockham(z(16, 128), z(16, 128), Direction.FORWARD)
    with pytest.raises(ValueError, match="gap-fused unsupported"):
        sk.fft_axes_gap_stockham(z(8, 2, 128), z(8, 2, 128),
                                 Direction.FORWARD)
    with pytest.raises(ValueError, match="gap-fused unsupported"):
        sk.fft_axes_gap_stockham(z(16, 2, 64), z(16, 2, 64),
                                 Direction.FORWARD)
    meta = torch.empty((1, 16, 2, 128), device="meta")
    with pytest.raises(ValueError):
        sk.fft_axes_gap(meta, meta, -1)


# --- plans under REGENT_FFT_GAP_FUSED=1 ---------------------------------------
@pytest.fixture
def gap_fused(monkeypatch):
    monkeypatch.setenv("REGENT_FFT_GAP_FUSED", "1")
    rt.clear_plan_cache()
    R.clear_plan_cache()
    yield
    rt.clear_plan_cache()
    R.clear_plan_cache()


PLANS = [((16, 4, 128), (0, 1, 2), Norm.BACKWARD,
          ["(axis 0: kernel-gap-fused(16, 128))",
           "(axis 1: kernel-butterfly(n=4))"]),
         ((2, 16, 8, 256), (1, 2, 3), Norm.ORTHO,
          ["(axis 1: kernel-gap-fused(16, 256))",
           "(axis 2: kernel-butterfly(n=8))"]),
         ((2, 16, 8, 128), (0, 1, 2, 3), Norm.FORWARD,
          ["(axis 1: kernel-gap-fused(16, 128))",
           "(axis 2: kernel-butterfly(n=8))",
           "(axis 0: kernel-butterfly(n=2))"])]


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
@pytest.mark.parametrize("shape,axes,norm,want", PLANS)
def test_gap_plans_match_jax(gap_fused, shape, axes, norm, want, dtype):
    tp = rt.make_plan(shape, axes=axes, norm=norm, backend="stockham",
                      dtype=dtype, device="cpu")
    jp = R.make_plan(shape, axes=axes, kind=JKind.C2C,
                     direction=JDirection.FORWARD, norm=JNorm(norm.value),
                     backend="stockham", dtype=dtype)
    assert tp.steps[0] == ("stockham_gap", len(shape) - 3,
                           (shape[-3], shape[-1]))
    assert tp.fused
    (tr, ti), (jr, ji), xd = _planes(shape, 9, dtype)
    x = SplitComplex(tr, ti)
    y = tp(x if dtype == "complex32" else torch.complex(tr, ti))
    jy = jp(JSplit(jr, ji) if dtype == "complex32"
            else np.asarray(jr) + 1j * np.asarray(ji))
    # the JAX plan records its step lines when it runs
    assert _lines(tp.describe()) == want == _lines(jp.describe())
    n = tp.spec.logical_n
    tol = tolerance(n, dtype)
    scale = rt.plan._norm_scale(tp.spec)
    assert rel_l2(y, to_numpy_complex(jy)) <= tol
    assert rel_l2(y, _ref(xd, axes, -1, scale)) <= tol
    inv = tp.inverse()
    assert inv.steps[0][0] == "stockham_gap"
    assert rel_l2(inv(y), xd) <= 2 * tol


def test_gap_route_needs_the_switch_and_its_gates(monkeypatch):
    def lines(shape, axes, **kw):
        rt.clear_plan_cache()
        return _lines(rt.make_plan(shape, axes=axes, backend="stockham",
                                   device="cpu", **kw).describe())
    monkeypatch.delenv("REGENT_FFT_GAP_FUSED", raising=False)
    assert lines((16, 4, 128), (0, 1, 2)) == [
        "(axis 2: kernel-butterfly(n=128))", "(axis 1: kernel-butterfly(n=4))",
        "(axis 0: kernel-butterfly(n=16))"]
    monkeypatch.setenv("REGENT_FFT_GAP_FUSED", "1")
    assert lines((16, 4, 128), (0, 1, 2))[0] == \
        "(axis 0: kernel-gap-fused(16, 128))"
    # a mid axis that is no power of two, a leading axis below 16, a
    # missing axis, complex128 and the xla backend keep their routes
    assert "gap" not in " ".join(lines((16, 3, 128), (0, 1, 2)))
    assert "gap" not in " ".join(lines((8, 4, 128), (0, 1, 2)))
    assert "gap" not in " ".join(lines((16, 4, 128), (0, 2)))
    assert "gap" not in " ".join(lines((16, 4, 128), (0, 1, 2),
                                       dtype="complex128"))
    rt.clear_plan_cache()
    p = rt.make_plan((16, 4, 128), backend="xla", device="cpu")
    assert all(k != "stockham_gap" for k, _, _ in p.steps)
    rt.clear_plan_cache()


def test_gap_switch_keys_the_plan_cache(monkeypatch):
    """A plan cached before the switch changes does not hide the other
    route, and inverse() keeps its forward plan's route."""
    def plan():
        return rt.make_plan((16, 4, 128), backend="stockham", device="cpu")
    rt.clear_plan_cache()
    monkeypatch.delenv("REGENT_FFT_GAP_FUSED", raising=False)
    grid = plan()
    monkeypatch.setenv("REGENT_FFT_GAP_FUSED", "1")
    gap = plan()
    assert gap is not grid and gap.gap_fused and not grid.gap_fused
    assert gap.steps[0][0] == "stockham_gap"
    assert all(k != "stockham_gap" for k, _, _ in grid.steps)
    assert all(k != "stockham_gap" for k, _, _ in grid.inverse().steps)
    monkeypatch.delenv("REGENT_FFT_GAP_FUSED")
    assert plan() is grid
    inv = gap.inverse()
    assert inv.gap_fused and inv.steps[0][0] == "stockham_gap"
    assert inv.inverse() is gap
    rt.destroy_plan(gap)
    monkeypatch.setenv("REGENT_FFT_GAP_FUSED", "1")
    assert plan() is not gap and plan().steps[0][0] == "stockham_gap"
    rt.clear_plan_cache()
