"""The precision tiers and the axis-0 pass in the port against the JAX
package on the CPU.

``precision="high"`` and ``"default"`` plan the steps of ``"highest"`` in
every dtype; the port computes exact f32 (f64 for complex128) at each tier,
so its values are held to the dtype's ``tolerance(n, dtype)`` against
the JAX plan and numpy.  ``fft_axis0`` (``_runner_axis0``'s counterpart) is
held against the JAX runner in interpret mode under each of its
``REGENT_FFT_TAIL_PREC`` schemes, at that scheme's bound from
``tests/test_pallas_kernels.py::test_tail_precision_schemes``, and within
5e-7 of numpy in float64 (the bound of the exact schemes).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

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
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm, SplitComplex
from regent_fft_tpu_torch.ops import stockham_kernels as tsk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

REPO = Path(__file__).resolve().parent.parent


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _step_lines(text):
    return [ln.strip() for ln in text.splitlines() if ln.startswith("  (")]


# --- the tiers -----------------------------------------------------------------
TIER_CASES = [((4, 64, 256), (0, 1, 2), "stockham"), ((6, 1024), (1,), "auto"),
              ((8, 8, 8), (0, 1, 2), "xla"), ((512, 256), (0,), "stockham")]


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("shape,axes,backend", TIER_CASES)
def test_precision_tier_plan_matches_jax(shape, axes, backend, precision,
                                         dtype):
    x = _crand(shape, 5).astype(np.complex64)
    kw = dict(axes=axes, backend=backend, dtype=dtype, precision=precision)
    jp = R.make_plan(shape, kind=JKind.C2C, direction=JDirection.FORWARD,
                     **kw)
    tp = rt.make_plan(shape, kind=Kind.C2C, direction=Direction.FORWARD,
                      device="cpu", **kw)
    top = rt.make_plan(shape, axes=axes, backend=backend, dtype=dtype,
                       device="cpu")
    assert tp.spec.precision == jp.spec.precision == precision
    assert tp.spec.use_3m == jp.spec.use_3m is False
    assert f"precision={precision}" in tp.describe()
    assert _step_lines(tp.describe())[:-1] == _step_lines(jp.describe())[:-1]
    assert [s[:2] for s in tp.steps] == [s[:2] for s in top.steps]
    assert _step_lines(tp.describe())[:-1] == _step_lines(top.describe())[:-1]
    tol = tolerance(tp.spec.logical_n, dtype)
    if dtype == "complex32":
        tr, ti = _t(x.real).to(torch.bfloat16), _t(x.imag).to(torch.bfloat16)
        xd = tr.double().numpy() + 1j * ti.double().numpy()
        y = tp(SplitComplex(tr, ti))
        jy = jp(JSplit(jnp.asarray(x.real, jnp.bfloat16),
                       jnp.asarray(x.imag, jnp.bfloat16)))
        assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
    else:
        xd = x.astype(np.complex128)
        y, jy = tp(x), jp(x)
        assert y.dtype == torch.complex64
    assert rel_l2(y, to_numpy_complex(jy)) <= tol
    assert rel_l2(y, np.fft.fftn(xd, axes=axes)) <= tol
    back = tp.inverse()(y)
    if dtype == "complex32":
        assert isinstance(back, SplitComplex)
    else:
        assert back.dtype == torch.complex64
    assert rel_l2(back, xd) <= 2 * tol


def test_complex32_highest_still_downgrades():
    """complex32 "highest" becomes "default" with 3M products in both
    packages; an explicit "high" or "default" stays as asked."""
    for precision, want in (("highest", ("default", True)),
                            ("high", ("high", False)),
                            ("default", ("default", False))):
        tp = rt.make_plan((4, 64), dtype="complex32", precision=precision,
                          device="cpu")
        jp = R.make_plan((4, 64), axes=(0, 1), kind=JKind.C2C,
                         direction=JDirection.FORWARD, dtype="complex32",
                         precision=precision)
        assert (tp.spec.precision, tp.spec.use_3m) == want
        assert (jp.spec.precision, jp.spec.use_3m) == want


_SCRIPT = r"""
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import regent_fft_tpu as R
import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.utils.verify import rel_l2

def lines(p):
    return [l.strip() for l in p.describe().splitlines() if l.startswith("  (")][:-1]

rng = np.random.default_rng(0)
out = {}
for shape, axes, backend in [((6, 640), (1,), "auto"),
                             ((4, 16, 16, 16), (1, 2, 3), "stockham"),
                             ((6, 1024), (1,), "pallas")]:
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for prec in ("high", "default"):
        kw = dict(axes=axes, dtype="complex128", backend=backend,
                  precision=prec)
        jp = R.make_plan(shape, kind=R.Kind.C2C, direction=R.Direction(-1),
                         **kw)
        tp = rt.make_plan(shape, kind=rt.Kind.C2C,
                          direction=rt.Direction(-1), device="cpu", **kw)
        ty = tp(x)
        out[f"{shape}{prec}"] = [rel_l2(ty, np.asarray(jp(x))),
                                 rel_l2(ty, np.fft.fftn(x, axes=axes)),
                                 lines(tp) == lines(jp), str(ty.dtype),
                                 f"precision={prec}" in tp.describe()]
print(json.dumps(out))
"""


def test_complex128_tiers_match_jax_x64():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(res) == 6
    for key, (err_jax, err_np, same_lines, dt, tier) in res.items():
        assert err_jax <= tolerance(2 ** 16, "complex128"), (key, err_jax)
        assert err_np <= tolerance(2 ** 16, "complex128"), (key, err_np)
        assert same_lines and tier, key
        assert dt == "torch.complex128", key


# --- the axis-0 pass -----------------------------------------------------------
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("prec,tol", [
    ("b6", 5e-7), ("b3", 2e-5), ("b32", 2e-5), ("b62", 5e-7),
    ("default", 5e-7),
])
def test_axis0_plain_matches_jax_runner_under_each_scheme(prec, tol, sign,
                                                         monkeypatch):
    monkeypatch.setenv("REGENT_FFT_TAIL_PREC", prec)
    monkeypatch.setenv("REGENT_FFT_A0FS_PREC", prec)
    x = _crand((512, 256), 17)
    run = jps._runner_axis0(512, sign, 128, interpret=True,
                            envkey=jps._env_key())
    jr, ji = run(jnp.asarray(x.real, jnp.float32),
                 jnp.asarray(x.imag, jnp.float32))
    jy = np.asarray(jr) + 1j * np.asarray(ji)
    yr, yi = tsk.fft_axis0_plain(_t(x.real), _t(x.imag), sign)
    assert yr.dtype == torch.float32 and yr.shape == (512, 256)
    y = torch.complex(yr, yi)
    ref = (np.fft.fft(x, axis=0) if sign < 0
           else np.fft.ifft(x, axis=0, norm="forward"))
    assert rel_l2(jy, ref) < tol            # the JAX scheme's own bound
    assert rel_l2(y, jy) <= tol
    assert rel_l2(y, ref) <= 5e-7


def test_rank2_axis0_step_takes_the_axis0_pass(monkeypatch):
    """Every axis-0 step of a rank-2 f32 array goes to fft_axis0, scaled
    or not; it gives the JAX plan's values and step line."""
    calls = []
    real = tsk.fft_axis0

    def spy(xr, xi, sign, scale=1.0):
        calls.append((tuple(xr.shape), scale))
        return real(xr, xi, sign, scale)
    monkeypatch.setattr(tsk, "fft_axis0", spy)
    x = _crand((512, 96), 3).astype(np.complex64)
    for norm, want in ((Norm.BACKWARD, [((512, 96), 1.0)]),
                       (Norm.ORTHO, [((512, 96), pytest.approx(512 ** -0.5))]),
                       (Norm.FORWARD, [((512, 96), pytest.approx(1 / 512))])):
        calls.clear()
        tp = rt.make_plan(x.shape, axes=(0,), backend="stockham", norm=norm,
                          device="cpu")
        jp = R.make_plan(x.shape, axes=(0,), kind=JKind.C2C,
                         direction=JDirection.FORWARD, backend="stockham",
                         norm=JNorm(norm.value))
        assert _step_lines(tp.describe())[:-1] == \
            ["(axis 0: kernel-butterfly(n=512))"]
        assert _step_lines(tp.describe())[:-1] == \
            _step_lines(jp.describe())[:-1]
        y = tp(x)
        assert calls == want
        assert rel_l2(y, to_numpy_complex(jp(x))) <= tolerance(512)
    # bf16 planes keep fft_cols (fft_axis0 takes f32 only)
    calls.clear()
    rt.make_plan(x.shape, axes=(0,), backend="stockham", dtype="complex32",
                 device="cpu")(x)
    assert calls == []


def test_axis0_wrapper_checks():
    x = torch.zeros(64, 8)
    before = dict(tsk.LAUNCHES)
    yr, yi = tsk.fft_axis0(x, x, -1)
    assert tsk.LAUNCHES == before and yr.shape == (64, 8)
    for dt in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="fft_axis0"):
            tsk.fft_axis0(x.to(dt), x.to(dt), -1)
