"""The JAX package's user switches in the port, against the JAX package on
the CPU: the bf16 four-step tile bodies under ``REGENT_FFT_MXU_IMPL``, the
plan's route switches (``REGENT_FFT_AXIS0_IMPL``, ``REGENT_FFT_F2_IMPL``,
``REGENT_FFT_DMA_MIN_POST``, ``REGENT_FFT_R2C_1D``), the lane-padded real
layout, ``REGENT_FFT_NATIVE=0`` and the plan log (``REGENT_FFT_LOG``).

Inputs are made with numpy from a seed.  Bounds: ``tolerance(n)`` for f32
bodies and plans (the JAX bodies are called as jnp functions at HIGHEST
precision, the port's run ``torch.matmul`` at full f32), and
``tolerance(n, "complex32")`` for bf16 planes (one bf16 rounding of the
output), each also against numpy in float64.  The switches are set with
monkeypatch, and both plan caches are cleared around each plan test.

The JAX plan takes the four-step and ring routes only on the TPU (in
interpret mode it keeps the butterfly and grid passes, plan.py:459-532), so
where a switch names one of them, the port's step lines are held against
the port's plan that names the same impl in its spec (whose TPU step lines
``tests/test_torch_port_fourstep.py`` holds), and its output against the
JAX plan's.
"""
import io
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.dtypes import Kind as JKind
from regent_fft_tpu.dtypes import SplitComplex as JSplit
from regent_fft_tpu.native import planner as Rnative
from regent_fft_tpu.ops import factor as jfactor
from regent_fft_tpu.ops import pallas_stockham as jps
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.dtypes import Direction, Kind, SplitComplex
from regent_fft_tpu_torch.native import planner as native
from regent_fft_tpu_torch.ops import factor
from regent_fft_tpu_torch.ops import stockham_kernels as tsk
from regent_fft_tpu_torch.utils import plog
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

MXU_LENGTHS = [64, 128, 256, 512, 1024, 2048]   # mxu_tile_supported
SWITCHES = ("REGENT_FFT_GAP_FUSED", "REGENT_FFT_AXIS0_IMPL",
            "REGENT_FFT_F2_IMPL", "REGENT_FFT_DMA_MIN_POST",
            "REGENT_FFT_R2C_1D", "REGENT_FFT_MXU_IMPL")


@pytest.fixture
def clean(monkeypatch):
    """No switch set, both plan caches empty before and after."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    rt.clear_plan_cache()
    R.clear_plan_cache()
    yield monkeypatch
    rt.clear_plan_cache()
    R.clear_plan_cache()


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _split(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real)),
            torch.from_numpy(np.ascontiguousarray(x.imag)))


def _lines(text):
    """The step and real-axis lines of a describe() text."""
    return [ln.strip() for ln in text.splitlines()
            if ln.startswith("  (") and "flops=" not in ln]


# --- the tables and bodies ----------------------------------------------------
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", MXU_LENGTHS)
def test_mxu_tables_bit_identical(n, sign):
    for a, b in zip(tsk._mxu_tables(n, sign), jps._mxu_tables(n, sign)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("body", ["mxu_tile", "mxu_tile_fs4m"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", MXU_LENGTHS)
def test_mxu_bodies_match_jax(body, n, sign):
    """The plain bodies against the JAX bodies (jnp, HIGHEST) and numpy
    float64, on (n, 6) f32 planes."""
    x = _crand((n, 6), n + sign)
    xr, xi = _split(x)
    y = torch.complex(*tsk._TILES[body](xr, xi, n, sign))
    wr, wi = (jnp.asarray(t) for t in jps._mxu_tables(n, sign))
    jbody = getattr(jps, "_" + body)
    jr, ji = jbody(jnp.asarray(x.real), jnp.asarray(x.imag), n, sign, wr, wi,
                   precision=jax.lax.Precision.HIGHEST)
    xd = x.astype(np.complex128)
    ref = np.fft.fft(xd, axis=0) if sign < 0 else np.fft.ifft(xd, axis=0) * n
    tol = tolerance(n)
    assert rel_l2(y, to_numpy_complex(JSplit(jr, ji))) <= tol
    assert rel_l2(y, ref) <= tol


@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("impl", [None, "direct", "fourstep", "fs4m", "fstw",
                                  "bogus"])
def test_tile_impl_follows_the_switch_as_jax(clean, impl, io):
    if impl is not None:
        clean.setenv("REGENT_FFT_MXU_IMPL", impl)
    gated = [n for n in range(2, tsk.MAX_STOCKHAM_N + 1)
             if tsk.kernel_len_ok(n, False)]
    assert set(MXU_LENGTHS) <= set(gated)
    for n in gated:
        want = jps._tile_impl(io, n)[0].__name__.lstrip("_")
        assert tsk.tile_impl(io, n) == want, (impl, io, n)
        assert want in tsk._TILES


def test_mxu_impl_scope_beats_the_environment(clean):
    clean.setenv("REGENT_FFT_MXU_IMPL", "fs4m")
    assert tsk.tile_impl("bf16", 1024) == "mxu_tile_fs4m"
    with tsk.mxu_impl_scope("fourstep"):
        assert tsk.tile_impl("bf16", 1024) == "mxu_tile"
        with tsk.mxu_impl_scope(None):
            assert tsk.tile_impl("bf16", 1024) == "mxu_tile_fs4m"
    assert tsk.tile_impl("bf16", 256) == "mxu_tile_fs4m"
    assert tsk.tile_impl("f32", 256) == "stockham_tile"


# --- the bf16 runners under the switch, against the JAX runners ----------------
RUNNERS = {
    "last": ((8, 1024), (1,),
             lambda r, i, d: tsk.fft_axis_stockham(r, i, -1, d),
             lambda r, i, d: jps.fft_axis_stockham(r, i, -1, d,
                                                   interpret=True)),
    "cols": ((1, 1024, 128), (1,),
             lambda r, i, d: tsk.fft_axis_stockham(r, i, 1, d),
             lambda r, i, d: jps.fft_axis_stockham(r, i, 1, d,
                                                   interpret=True)),
    "fused2": ((1, 256, 256), (1, 2),
               lambda r, i, d: tsk.fft_axes2_stockham(r, i, d),
               lambda r, i, d: jps.fft_axes2_stockham(r, i, d,
                                                      interpret=True)),
}


@pytest.mark.parametrize("runner", sorted(RUNNERS))
@pytest.mark.parametrize("impl", ["fourstep", "fs4m"])
def test_bf16_runners_under_the_switch_match_jax(clean, impl, runner):
    clean.setenv("REGENT_FFT_MXU_IMPL", impl)
    shape, axes, port, jax_fn = RUNNERS[runner]
    n = int(np.prod([shape[a] for a in axes]))
    assert tsk.tile_impl("bf16", shape[axes[0]]) == {
        "fourstep": "mxu_tile", "fs4m": "mxu_tile_fs4m"}[impl]
    x = _crand(shape, 5)
    tr, ti = (t.to(torch.bfloat16) for t in _split(x))
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    yr, yi = port(tr, ti, Direction.FORWARD)
    assert yr.dtype == torch.bfloat16 and tuple(yr.shape) == shape
    jr, ji = jax_fn(jnp.asarray(x.real, jnp.bfloat16),
                    jnp.asarray(x.imag, jnp.bfloat16), JDirection.FORWARD)
    y = SplitComplex(yr, yi)
    tol = tolerance(n, "complex32")
    assert rel_l2(y, to_numpy_complex(JSplit(jr, ji))) <= tol
    assert rel_l2(y, np.fft.fftn(xd, axes=axes)) <= tol


def test_complex32_plan_keeps_its_mxu_switch(clean):
    """The plan reads REGENT_FFT_MXU_IMPL once: a change after make_plan
    does not reach its bodies, and the cache keys on it."""
    shape = (8, 1024)
    clean.setenv("REGENT_FFT_MXU_IMPL", "fourstep")
    p = rt.make_plan(shape, axes=(1,), backend="stockham", dtype="complex32",
                     device="cpu")
    assert p.switches.mxu_impl == "fourstep"
    x = _crand(shape, 8)
    tr, ti = (t.to(torch.bfloat16) for t in _split(x))
    y = p(SplitComplex(tr, ti))
    ref = tsk.fft_axis_stockham(tr, ti, -1, Direction.FORWARD)
    clean.setenv("REGENT_FFT_MXU_IMPL", "fs4m")
    assert rt.make_plan(shape, axes=(1,), backend="stockham",
                        dtype="complex32", device="cpu") is not p
    y2 = p(SplitComplex(tr, ti))
    assert torch.equal(y.re, y2.re) and torch.equal(y.im, y2.im)
    assert torch.equal(y.re, ref[0]) and torch.equal(y.im, ref[1])
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    assert rel_l2(y, np.fft.fft(xd, axis=1)) <= tolerance(1024, "complex32")


# --- the route switches ---------------------------------------------------------
AXIS0_SHAPE = (256, 8, 128)          # axis 0 with post = 1024
F2_SHAPE = (4, 64, 256)              # the fused pair (64, 256)
ROUTE_CASES = [
    ("REGENT_FFT_AXIS0_IMPL", "fourstep", "axis0_impl", AXIS0_SHAPE,
     "(axis 0: kernel-fourstep-ring(n=256))"),
    ("REGENT_FFT_AXIS0_IMPL", "dma", "axis0_impl", AXIS0_SHAPE,
     "(axis 0: kernel-dma-ring(n=256))"),
    ("REGENT_FFT_AXIS0_IMPL", "grid", "axis0_impl", AXIS0_SHAPE,
     "(axis 0: kernel-butterfly(n=256))"),
    ("REGENT_FFT_F2_IMPL", "ring", "f2_impl", F2_SHAPE,
     "(axis 1: kernel-fused2-ring(64, 256))"),
    ("REGENT_FFT_F2_IMPL", "grid", "f2_impl", F2_SHAPE,
     "(axis 1: kernel-fused2(64, 256))"),
    # the JAX plan reads the variable at the fused pair's dispatch only:
    # "off" there keeps the pair fused, on the grid pass
    ("REGENT_FFT_F2_IMPL", "off", "f2_impl", F2_SHAPE,
     "(axis 1: kernel-fused2(64, 256))"),
]
_JAX_OUT = {}


def _jax_out(shape):
    """The JAX plan's output on the shape's input (its CPU route does not
    depend on these switches)."""
    if shape not in _JAX_OUT:
        jp = R.make_plan(shape, axes=(0, 1, 2), kind=JKind.C2C,
                         direction=JDirection.FORWARD, backend="stockham")
        _JAX_OUT[shape] = (to_numpy_complex(jp(_crand(shape, 9))),
                           _lines(jp.describe()))
    return _JAX_OUT[shape]


@pytest.mark.parametrize("var,value,field,shape,line", ROUTE_CASES)
def test_route_switch_plans(clean, var, value, field, shape, line):
    clean.setenv("REGENT_FFT_DMA_MIN_POST", "1024")
    clean.setenv(var, value)
    p = rt.make_plan(shape, backend="stockham", device="cpu")
    assert line in _lines(p.describe())
    clean.delenv(var)
    spec_value = "grid" if value == "off" else value
    q = rt.make_plan(shape, backend="stockham", device="cpu",
                     **{field: spec_value})
    assert q is not p and _lines(q.describe()) == _lines(p.describe())
    jy, jlines = _jax_out(shape)
    if "ring" not in line:       # the JAX plan's CPU routes
        assert _lines(p.describe()) == jlines
    x = _crand(shape, 9)
    y = p(x)
    tol = tolerance(int(np.prod(shape)))
    assert rel_l2(y, jy) <= tol
    assert rel_l2(y, np.fft.fftn(x.astype(np.complex128))) <= tol
    inv = p.inverse()
    assert inv.switches == p.switches and line in _lines(inv.describe())
    assert rel_l2(inv(y), x) <= tol


def test_dma_min_post_gates_the_leading_axis_routes(clean):
    """REGENT_FFT_DMA_MIN_POST replaces the default 65536: post = 1024 takes
    the routes only under a gate of 1024 or less."""
    def line(**kw):
        return _lines(rt.make_plan(AXIS0_SHAPE, backend="stockham",
                                   device="cpu", **kw).describe())[-1]
    assert line(axis0_impl="fourstep") == "(axis 0: kernel-butterfly(n=256))"
    clean.setenv("REGENT_FFT_DMA_MIN_POST", "1024")
    assert line(axis0_impl="fourstep") == (
        "(axis 0: kernel-fourstep-ring(n=256))")
    assert line(axis0_impl="dma") == "(axis 0: kernel-dma-ring(n=256))"
    clean.setenv("REGENT_FFT_DMA_MIN_POST", "1025")
    assert line(axis0_impl="dma") == "(axis 0: kernel-butterfly(n=256))"
    clean.setenv("REGENT_FFT_DMA_MIN_POST", "lots")
    with pytest.raises(ValueError):
        rt.make_plan(AXIS0_SHAPE, device="cpu")


def test_spec_named_impl_beats_the_switch(clean):
    clean.setenv("REGENT_FFT_DMA_MIN_POST", "1024")
    clean.setenv("REGENT_FFT_AXIS0_IMPL", "dma")
    clean.setenv("REGENT_FFT_F2_IMPL", "ring")

    def lines(shape, **kw):
        return _lines(rt.make_plan(shape, backend="stockham", device="cpu",
                                   **kw).describe())
    assert "(axis 0: kernel-dma-ring(n=256))" in lines(AXIS0_SHAPE)
    assert "(axis 0: kernel-butterfly(n=256))" in lines(AXIS0_SHAPE,
                                                        axis0_impl="grid")
    assert "(axis 0: kernel-fourstep-ring(n=256))" in lines(
        AXIS0_SHAPE, axis0_impl="fourstep")
    assert "(axis 1: kernel-fused2-ring(64, 256))" in lines(F2_SHAPE)
    assert "(axis 1: kernel-fused2(64, 256))" in lines(F2_SHAPE,
                                                       f2_impl="grid")
    # the spec's "off" unfuses the pair, as the JAX plan's does
    jp = R.make_plan(F2_SHAPE, axes=(0, 1, 2), kind=JKind.C2C,
                     direction=JDirection.FORWARD, backend="stockham",
                     f2_impl="off")
    assert lines(F2_SHAPE, f2_impl="off") == _lines(jp.describe())
    assert "(axis 2: kernel-butterfly(n=256))" in lines(F2_SHAPE,
                                                        f2_impl="off")


@pytest.mark.parametrize("var", ["REGENT_FFT_AXIS0_IMPL",
                                 "REGENT_FFT_F2_IMPL"])
def test_route_switches_are_validated(clean, var):
    clean.setenv(var, "bogus")
    with pytest.raises(ValueError, match=var):
        rt.make_plan((8, 8), device="cpu")
    with pytest.raises(ValueError, match=var):
        tplan.Switches.from_env()


def test_plan_cache_keys_on_every_switch(clean):
    base = rt.make_plan(F2_SHAPE, backend="stockham", device="cpu")
    assert base.switches == tplan.Switches()
    seen = {id(base)}
    for var, value in (("REGENT_FFT_GAP_FUSED", "1"),
                       ("REGENT_FFT_AXIS0_IMPL", "dma"),
                       ("REGENT_FFT_F2_IMPL", "ring"),
                       ("REGENT_FFT_DMA_MIN_POST", "1024"),
                       ("REGENT_FFT_R2C_1D", "half"),
                       ("REGENT_FFT_MXU_IMPL", "fs4m")):
        clean.setenv(var, value)
        p = rt.make_plan(F2_SHAPE, backend="stockham", device="cpu")
        assert id(p) not in seen, var
        seen.add(id(p))
        clean.delenv(var)
    assert rt.make_plan(F2_SHAPE, backend="stockham", device="cpu") is base


def test_inverse_keeps_the_forward_switches(clean):
    clean.setenv("REGENT_FFT_DMA_MIN_POST", "1024")
    clean.setenv("REGENT_FFT_AXIS0_IMPL", "fourstep")
    clean.setenv("REGENT_FFT_MXU_IMPL", "fs4m")
    p = rt.make_plan(AXIS0_SHAPE, backend="stockham", device="cpu")
    for k in SWITCHES:
        clean.delenv(k, raising=False)
    inv = p.inverse()
    assert inv.switches == p.switches
    assert inv.switches.mxu_impl == "fs4m" and inv.switches.dma_min_post == 1024
    assert "(axis 0: kernel-fourstep-ring(n=256))" in _lines(inv.describe())
    assert inv.inverse() is p
    fresh = rt.make_plan(AXIS0_SHAPE, backend="stockham", device="cpu",
                         direction=Direction.BACKWARD)
    assert fresh is not inv and fresh.switches == tplan.Switches()


# --- REGENT_FFT_R2C_1D=half -------------------------------------------------------
@pytest.mark.parametrize("shape,axes", [((8, 1024), (1,)),
                                        ((4, 16, 256), (1, 2))])
def test_r2c_half_switch_matches_jax(clean, shape, axes):
    """A 1-D R2C at a kernel length takes the half-length route; a
    multi-axis one the dense reduction, as the JAX plan under the same
    variable (plan.py:652-655)."""
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)

    def plans():
        rt.clear_plan_cache()
        R.clear_plan_cache()
        tp = rt.make_plan(shape, axes=axes, kind=Kind.R2C,
                          direction=Direction.FORWARD, backend="stockham",
                          device="cpu")
        jp = R.make_plan(shape, axes=axes, kind=JKind.R2C,
                         direction=JDirection.FORWARD, backend="stockham")
        return tp, jp
    tp, jp = plans()
    jy = to_numpy_complex(jp(x))
    assert tp.real.route == "kernel"
    assert _lines(tp.describe()) == _lines(jp.describe())
    clean.setenv("REGENT_FFT_R2C_1D", "half")
    hp, hjp = plans()
    hjy = to_numpy_complex(hjp(x))
    assert hp.real.route == ("half" if len(axes) == 1 else "einsum")
    assert _lines(hp.describe()) == _lines(hjp.describe())
    n = int(np.prod([shape[a] for a in axes]))
    tol = tolerance(n)
    ref = np.fft.rfftn(x.astype(np.float64), axes=axes)
    y = hp(x)
    assert rel_l2(y, hjy) <= tol and rel_l2(y, jy) <= tol
    assert rel_l2(y, ref) <= tol
    # the C2R plan is not switched
    c = rt.make_plan(shape, axes=axes, kind=Kind.C2R,
                     direction=Direction.BACKWARD, backend="stockham",
                     device="cpu")
    assert c.switches.r2c_half and rel_l2(c(y), x) <= tol


# --- the lane-padded real layout -------------------------------------------------
@pytest.mark.parametrize("shape", [(6, 256), (2, 3, 128), (5, 16)])
def test_padded_r2c_matches_jax(shape):
    n = shape[-1]
    h = n // 2 + 1
    x = np.random.default_rng(n).standard_normal(shape).astype(np.float32)
    yr, yi = tsk.fft_last_r2c_stockham(torch.from_numpy(x), padded=True)
    assert tuple(yr.shape) == tuple(yi.shape) == shape
    assert not yr[..., h:].any() and not yi[..., h:].any()
    jr, ji = jps.fft_last_r2c_stockham(jnp.asarray(x), interpret=True,
                                       padded=True)
    assert tuple(jr.shape) == shape
    nr, ni = tsk.fft_last_r2c_stockham(torch.from_numpy(x))
    assert torch.equal(yr[..., :h], nr) and torch.equal(yi[..., :h], ni)
    y = torch.complex(yr, yi)
    tol = tolerance(n)
    assert rel_l2(y, np.asarray(jr) + 1j * np.asarray(ji)) <= tol
    ref = np.zeros(shape, np.complex128)
    ref[..., :h] = np.fft.rfft(x.astype(np.float64))
    assert rel_l2(y, ref) <= tol
    # packed wins over padded, as in the JAX package
    pr, _ = tsk.fft_last_r2c_stockham(torch.from_numpy(x), padded=True,
                                      packed=True)
    assert tuple(pr.shape) == shape[:-1] + (n // 2,)


@pytest.mark.parametrize("shape", [(6, 256), (2, 3, 128)])
def test_padded_c2r_matches_jax(shape):
    """(..., n) planes: the bins above n/2 are ignored (filled with noise
    here), the result equals the narrow one and the JAX entry's."""
    n = shape[-1]
    h = n // 2 + 1
    rng = np.random.default_rng(n + 1)
    half = np.fft.rfft(rng.standard_normal(shape))
    full = np.concatenate([half, rng.standard_normal(shape[:-1] + (n - h,))
                           * (1 + 1j)], -1).astype(np.complex64)
    fr, fi = _split(full)
    y = tsk.ifft_last_c2r_stockham(fr, fi, n, scale=0.5)
    assert tuple(y.shape) == shape
    narrow = tsk.ifft_last_c2r_stockham(fr[..., :h].contiguous(),
                                        fi[..., :h].contiguous(), n,
                                        scale=0.5)
    assert torch.equal(y, narrow)
    jy = jps.ifft_last_c2r_stockham(jnp.asarray(full.real),
                                    jnp.asarray(full.imag), n,
                                    interpret=True)
    tol = tolerance(n)
    assert rel_l2(y, 0.5 * np.asarray(jy)) <= tol
    ref = np.fft.irfft(full[..., :h].astype(np.complex128), n) * n * 0.5
    assert rel_l2(y, ref) <= tol


def test_padded_round_trip():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, 64, 128)).astype(np.float32))
    yr, yi = tsk.fft_last_r2c_stockham(x, padded=True)
    back = tsk.ifft_last_c2r_stockham(yr, yi, 128, scale=1 / 128)
    assert rel_l2(back, x.numpy()) <= tolerance(128)


# --- REGENT_FFT_NATIVE=0 ---------------------------------------------------------
NATIVE_NS = [12, 97, 360, 1000, 1024, 3000, 4096, 6561, 10007, 46080]


def test_native_switch_off_takes_the_python_fallback(monkeypatch):
    monkeypatch.delenv("REGENT_FFT_NATIVE", raising=False)
    assert native.load() is not None
    built = {n: (native.factorize(n), native.next_fast_len(n))
             for n in NATIVE_NS}
    monkeypatch.setenv("REGENT_FFT_NATIVE", "0")
    assert native.load() is None and not native.available()
    assert Rnative.load() is None
    for n in NATIVE_NS:
        assert native.factorize(n) is None and native.best_schedule(n) is None
        assert factor.factorize(n) == built[n][0], n
        assert factor.next_fast_len(n) == built[n][1], n
        fallback = factor.schedule(n, mode="model", device="cpu")
        assert fallback == jfactor.schedule(n, 128, "model"), n
        assert fallback == factor.factorize(n), n
    p = rt.plan._build_core(rt.PlanSpec(shape=(4, 1000), axes=(1,),
                                        kind=Kind.C2C,
                                        direction=Direction.FORWARD,
                                        device="cpu"))
    assert p.cost() == 0.0
    monkeypatch.delenv("REGENT_FFT_NATIVE")
    assert native.load() is not None


# --- the plan log ------------------------------------------------------------------
def test_log_switch_prints_make_plan_on_stderr():
    """REGENT_FFT_LOG=1 in a fresh process prints the make_plan line on
    stderr, in the JAX package's format."""
    from regent_fft_tpu.utils import plog as jplog
    assert plog._handler.formatter._fmt == jplog._handler.formatter._fmt
    env = dict(os.environ, REGENT_FFT_LOG="1")
    r = subprocess.run([sys.executable, "-c", "import regent_fft_tpu_torch "
                        "as rt; rt.make_plan((8, 64), device='cpu')"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    err = r.stderr.splitlines()
    assert any(ln.startswith("[regent_fft_tpu_torch INFO] make_plan: "
                             "Plan(c2c, shape=(8, 64)") for ln in err), r.stderr
    assert not any("DEBUG" in ln for ln in err)


@pytest.mark.parametrize("value,level", [("0", logging.WARNING),
                                         ("1", logging.INFO),
                                         ("2", logging.DEBUG),
                                         ("two", logging.WARNING)])
def test_log_level_from_the_environment(monkeypatch, value, level):
    """The JAX ``_init_level``: the variable's level, a malformed one 0."""
    monkeypatch.setenv("REGENT_FFT_LOG", value)
    try:
        plog._init_level()
        assert plog.logger.level == level
    finally:
        plog.set_log_level(0)


def test_set_log_level_prints_without_caplog():
    """set_log_level(2) in-process: the logger's own handler writes the
    make_plan and schedule records (no caplog handler attached)."""
    assert plog.logger.propagate is False
    stream = io.StringIO()
    old = plog._handler.setStream(stream)
    plog.set_log_level(2)
    try:
        rt.clear_plan_cache()
        rt.make_plan((4, 32), device="cpu")
        plog.set_log_level(0)
        rt.clear_plan_cache()
        rt.make_plan((4, 32), device="cpu")
    finally:
        plog.set_log_level(0)
        plog._handler.setStream(old)
        rt.clear_plan_cache()
    err = stream.getvalue()
    assert err.count("[regent_fft_tpu_torch INFO] make_plan: Plan(c2c, "
                     "shape=(4, 32)") == 1
    assert "[regent_fft_tpu_torch DEBUG] schedule:" in err
    assert "direct-einsum(n=32)" in err
