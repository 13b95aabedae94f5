"""complex128 plans in the port: f64 planes through the contraction steps
(no kernel step: the kernels compute in f32, plan.py:331), against numpy in
float64 and, in a subprocess with ``JAX_ENABLE_X64=1``, against the JAX
package's complex128 plans.

Tolerance: ``tolerance(n, "complex128")`` = 8 * 2^-52 * sqrt(log2 n), the
JAX package's bound for f64 planes; the tables are generated in float64
and every product runs in f64, so the errors are a few ulp of f64.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm
from regent_fft_tpu_torch.plan import STEPS, _norm_scale
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

REPO = Path(__file__).resolve().parent.parent
NP_NORM = {Norm.BACKWARD: "backward", Norm.ORTHO: "ortho",
           Norm.FORWARD: "forward"}


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _no_kernel_step(plan):
    assert plan.cdtype == torch.float64
    assert plan.steps and not any(STEPS[k].kernel for k, _, _ in plan.steps)
    assert plan.real is None or plan.real.route == "einsum"
    assert "kernel" not in plan.describe()


C2C_CASES = [((2048,), (0,)), ((6, 1000), (1,)), ((64, 48), (0, 1)),
             ((4, 16, 16, 16), (1, 2, 3)), ((3, 96, 5), (1,))]


@pytest.mark.parametrize("norm", list(Norm))
@pytest.mark.parametrize("backend", ["auto", "stockham"])
@pytest.mark.parametrize("shape,axes", C2C_CASES)
def test_complex128_c2c_plan_matches_numpy(shape, axes, backend, norm):
    x = _crand(shape, 3)
    n = int(np.prod([shape[a] for a in axes]))
    tol = tolerance(n, "complex128")
    for direction in (Direction.FORWARD, Direction.BACKWARD):
        p = rt.make_plan(shape, axes=axes, direction=direction, norm=norm,
                         dtype="complex128", backend=backend, device="cpu")
        _no_kernel_step(p)
        y = p(x)
        assert y.dtype == torch.complex128 and tuple(y.shape) == shape
        ref = (np.fft.fftn(x, axes=axes) if direction == Direction.FORWARD
               else np.fft.ifftn(x, axes=axes, norm="forward"))
        assert rel_l2(y, ref * _norm_scale(p.spec)) <= tol
        assert rel_l2(p.inverse()(y), x) <= tol


REAL_CASES = [((256,), (0,)), ((4, 1024), (1,)), ((24, 32), (0, 1)),
              ((12, 16, 20), (0, 1, 2)), ((2, 8, 16, 30), (1, 3))]


@pytest.mark.parametrize("norm", list(Norm))
@pytest.mark.parametrize("shape,axes", REAL_CASES)
def test_complex128_real_plans_match_numpy(shape, axes, norm):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape)
    n = int(np.prod([shape[a] for a in axes]))
    tol = tolerance(n, "complex128")
    kw = {} if norm == Norm.NONE else dict(norm=NP_NORM[norm])
    r2c = rt.make_plan(shape, axes=axes, kind=Kind.R2C,
                       direction=Direction.FORWARD, norm=norm,
                       dtype="complex128", backend="stockham", device="cpu")
    if len(axes) > 1:                   # a 1-D real plan has no C2C step
        _no_kernel_step(r2c)
    h = r2c(x)
    assert h.dtype == torch.complex128
    ref = np.fft.rfftn(x, axes=axes, **kw)
    assert rel_l2(h, ref) <= tol
    c2r = r2c.inverse()
    y = c2r(ref)
    assert y.dtype == torch.float64 and tuple(y.shape) == shape
    # inverse() of an unscaled R2C plan is the 1/n-scaled C2R (numpy's
    # default norm), so every norm round-trips to x
    want = np.fft.irfftn(ref, s=[shape[a] for a in axes], axes=axes, **kw)
    assert rel_l2(y, want) <= tol and rel_l2(y, x) <= tol
    assert r2c.real.route == "einsum" and c2r.real.route == "einsum"


def test_complex128_api_inference():
    """float64 / complex128 data plans complex128, as torch.fft does."""
    x = _crand((8, 64), 9)
    xr = x.real.copy()
    tol = tolerance(64, "complex128")
    y = rt.fft(x, device="cpu")
    assert y.dtype == torch.complex128
    assert rel_l2(y, np.fft.fft(x)) <= tol
    t = torch.from_numpy(x)
    assert rt.ifftn(t, device="cpu").dtype == torch.complex128
    assert rel_l2(rt.fft2(t, device="cpu"), np.fft.fft2(x)) \
        <= tolerance(512, "complex128")
    h = rt.rfft(xr, device="cpu")
    assert h.dtype == torch.complex128
    assert rel_l2(h, np.fft.rfft(xr)) <= tol
    z = rt.irfft(np.fft.rfft(xr), n=64, device="cpu")
    assert z.dtype == torch.float64 and rel_l2(z, xr) <= tol
    assert rel_l2(rt.hfft(x[:, :33], device="cpu"),
                  np.fft.hfft(x[:, :33])) <= tol
    assert rel_l2(rt.ihfft(torch.from_numpy(xr), device="cpu"),
                  np.fft.ihfft(xr)) <= tol
    # float32 / complex64 data keeps complex64
    assert rt.fft(x.astype(np.complex64), device="cpu").dtype \
        == torch.complex64
    assert rt.rfft(xr.astype(np.float32), device="cpu").dtype \
        == torch.complex64
    p = rt.make_plan((8, 64), axes=(1,), dtype="complex128", device="cpu")
    assert p.bytes_ideal == 2 * 8 * 64 * 16


_SCRIPT = r"""
import os, sys, json
os.environ["JAX_ENABLE_X64"] = "1"
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
for shape, axes, backend in [((1024,), (0,), "auto"), ((6, 640), (1,), "auto"),
                             ((64, 48), (0, 1), "stockham"),
                             ((4, 16, 16, 16), (1, 2, 3), "stockham"),
                             ((2, 256, 128), (0, 1, 2), "hybrid")]:
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for d in (-1, 1):
        jp = R.make_plan(shape, axes=axes, kind=R.Kind.C2C,
                         direction=R.Direction(d), dtype="complex128",
                         backend=backend)
        tp = rt.make_plan(shape, axes=axes, kind=rt.Kind.C2C,
                          direction=rt.Direction(d), dtype="complex128",
                          backend=backend, device="cpu")
        jy = np.asarray(jp(x))
        ty = tp(x)
        key = f"c2c{shape}{d}"
        out[key] = [rel_l2(ty, jy), lines(tp) == lines(jp),
                    str(jy.dtype), str(ty.dtype)]
xr = rng.standard_normal((12, 16, 20))
jy = np.asarray(R.rfftn(xr))
ty = rt.rfftn(xr, device="cpu")
out["rfftn"] = [rel_l2(ty, jy), True, str(jy.dtype), str(ty.dtype)]
jz = np.asarray(R.irfftn(jy, xr.shape))
tz = rt.irfftn(jy, s=xr.shape, device="cpu")
out["irfftn"] = [rel_l2(tz, jz), True, str(jz.dtype), str(tz.dtype)]
print(json.dumps(out))
"""


def test_complex128_matches_jax_x64():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(res) == 12
    for key, (err, same_lines, jdt, tdt) in res.items():
        # two f64 implementations of the same schedule: a few ulp apart
        assert err <= tolerance(2 ** 16, "complex128"), (key, err)
        assert same_lines, key
        assert jdt.replace("numpy.", "") in ("complex128", "float64"), jdt
        assert tdt in ("torch.complex128", "torch.float64"), (key, tdt)
