"""The port's API around plans against the JAX package on the CPU: the
reference's typed interface (``FFTInterface``/``generate_fft_interface``),
the shift and frequency helpers, the advisory worker count, ``core_fn`` and
the verify helpers (``verify_plan``, ``check_parseval``), mirroring
``tests/test_plan_api.py`` (interface and shift helpers),
``tests/test_measure.py`` (workers) and ``tests/test_autodiff.py``
(SplitComplex shift).

Inputs are made with numpy from a seed.  Tolerance: ``tolerance(n,
dtype)`` = 8 * eps * sqrt(log2 n), against the JAX plans' outputs and
numpy in float64; the shift and frequency helpers must equal numpy's
exactly.
"""
import numpy as np
import pytest
import torch

import regent_fft_tpu as R
from regent_fft_tpu.utils import verify as jverify
from regent_fft_tpu.utils.verify import to_numpy_complex

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import SplitComplex
from regent_fft_tpu_torch.utils import verify as tverify
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

RNG = np.random.default_rng(0)


def crand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# --- shift and frequency helpers ------------------------------------------
def test_fftshift_helpers():
    x = crand((9,))
    np.testing.assert_allclose(rt.fftfreq(8, device="cpu").numpy(),
                               np.fft.fftfreq(8).astype(np.float32))
    got = to_numpy_complex(rt.fftshift(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.fft.fftshift(x))
    np.testing.assert_array_equal(to_numpy_complex(rt.fftshift(x)),
                                  to_numpy_complex(R.fftshift(x)))


@pytest.mark.parametrize("shape,axes", [
    ((7,), None), ((7,), 0), ((8,), (-1,)), ((8, 5), None), ((8, 5), 1),
    ((6, 9), 0), ((6, 9), (0, 1)), ((6, 9), (-1,))])
def test_shifts_equal_numpy(shape, axes):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    for tf, nf, jf in ((rt.fftshift, np.fft.fftshift, R.fftshift),
                       (rt.ifftshift, np.fft.ifftshift, R.ifftshift)):
        got = tf(x, axes=axes)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), nf(x, axes=axes))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jf(x, axes=axes)))
    y = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(
        rt.ifftshift(rt.fftshift(torch.from_numpy(y), axes), axes).numpy(), y)


def test_fftshift_splitcomplex():
    """tests/test_autodiff.py:42: a SplitComplex shifts plane by plane."""
    x = np.arange(8).astype(np.float32)
    s = SplitComplex(torch.from_numpy(x), torch.from_numpy(-x))
    for tf, nf in ((rt.fftshift, np.fft.fftshift),
                   (rt.ifftshift, np.fft.ifftshift)):
        out = tf(s)
        assert isinstance(out, SplitComplex)
        np.testing.assert_array_equal(out.re.numpy(), nf(x))
        np.testing.assert_array_equal(out.im.numpy(), nf(-x))


@pytest.mark.parametrize("n,d", [(8, 1.0), (9, 0.5), (1, 2.0), (16, 0.1)])
def test_freqs_equal_jax_and_numpy(n, d):
    for tf, jf, nf in ((rt.fftfreq, R.fftfreq, np.fft.fftfreq),
                       (rt.rfftfreq, R.rfftfreq, np.fft.rfftfreq)):
        got = tf(n, d, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), nf(n, d).astype(np.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(jf(n, d)),
                                   rtol=1e-6)
        assert tf(n, d, dtype=torch.float64, device="cpu").dtype \
            == torch.float64


def test_freqs_default_to_the_card(monkeypatch):
    calls = []
    real_to = torch.Tensor.to

    def to(self, *a, **k):
        calls.append(k.get("device"))
        return real_to(self, *a, **{**k, "device": "cpu"})
    monkeypatch.setattr(torch.Tensor, "to", to)
    rt.fftfreq(4)
    rt.rfftfreq(4)
    assert calls == ["cuda", "cuda"]


# --- the reference-parity interface ----------------------------------------
def test_generate_fft_interface_c2c():
    iface = rt.generate_fft_interface(1, np.complex64, np.complex64,
                                      device="cpu")
    p = iface.make_plan((128,))
    x = crand((128,))
    y = iface.execute_plan(p, x)
    assert rel_l2(y, np.fft.fft(x)) < tolerance(128)
    jiface = R.generate_fft_interface(1, np.complex64, np.complex64)
    assert rel_l2(y, to_numpy_complex(jiface.execute_plan(
        jiface.make_plan((128,)), x))) < tolerance(128)
    iface.destroy_plan(p)
    with pytest.raises(RuntimeError, match="destroyed"):
        p(x)


def test_generate_fft_interface_r2c():
    iface = rt.generate_fft_interface(1, np.float32, np.complex64,
                                      device="cpu")
    assert iface.kind == rt.Kind.R2C
    p = iface.make_plan((64,))
    x = RNG.standard_normal(64).astype(np.float32)
    assert rel_l2(p(x), np.fft.rfft(x)) < tolerance(64)


def test_interface_batch_plan():
    iface = rt.generate_fft_interface(3, np.complex64, np.complex64,
                                      device="cpu")
    p = iface.make_plan_batch((8, 12, 5))
    assert p.spec.axes == (0, 1)
    x = crand((8, 12, 5))
    assert rel_l2(p(x), np.fft.fftn(x, axes=(0, 1))) < tolerance(96)
    q = iface.make_plan_batch((8, 12, 5), batch_axis=0)
    assert q.spec.axes == (1, 2)


def test_interface_rejects_bad_rank():
    with pytest.raises(ValueError):
        rt.generate_fft_interface(4, np.complex64, np.complex64)
    iface = rt.generate_fft_interface(2, np.complex64, np.complex64,
                                      device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        iface.make_plan((8,))


@pytest.mark.parametrize("din,dout,kind,dtype", [
    (np.complex64, np.complex64, "c2c", "complex64"),
    ("complex128", np.complex128, "c2c", "complex128"),
    (np.float32, np.complex64, "r2c", "complex64"),
    (np.float64, np.complex128, "r2c", "complex128"),
    (SplitComplex, SplitComplex, "c2c", "complex32"),
    (torch.complex64, torch.complex64, "c2c", "complex64"),
    ("float32", "complex32", "r2c", "complex32")])
def test_interface_types_equal_jax(din, dout, kind, dtype):
    """The kind and plan dtype the interface picks, as the JAX package's
    (src/fft.rg:36-39 real_flag dispatch)."""
    iface = rt.generate_fft_interface(2, din, dout, device="cpu")
    assert iface.kind.value == kind and iface._dtype_str() == dtype
    p = iface.make_plan((4, 6))
    assert p.spec.kind.value == kind and p.spec.dtype == dtype
    jin = {SplitComplex: "complex32", torch.complex64: np.complex64}.get(
        din, din)
    jout = {SplitComplex: "complex32", torch.complex64: np.complex64}.get(
        dout, dout)
    j = R.generate_fft_interface(2, jin, jout)
    assert j.kind.value == kind and j._dtype_str() == dtype


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_interface_plan_is_the_cached_plan(dtype):
    """make_plan of the interface is make_plan's cached plan (norm "none"),
    and destroy_plan evicts it; the result is numpy's and the JAX
    interface plan's."""
    iface = rt.generate_fft_interface(3, dtype, dtype, device="cpu")
    p = iface.make_plan((16, 12, 10))
    assert p is rt.make_plan((16, 12, 10), norm="none", device="cpu",
                             dtype=np.dtype(dtype).name)
    assert p in rt.cached_plans()
    x = crand((16, 12, 10), 3).astype(dtype)
    y = iface.execute_plan_task(p, x)
    tol = tolerance(x.size, np.dtype(dtype).name)
    assert rel_l2(y, np.fft.fftn(x.astype(np.complex128))) <= tol
    if dtype == np.complex64:    # complex128 JAX plans need x64
        j = R.generate_fft_interface(3, dtype, dtype)
        jy = j.execute_plan(j.make_plan((16, 12, 10)), x)
        assert rel_l2(y, to_numpy_complex(jy)) <= tol
    iface.destroy_plan_task(p)
    assert p not in rt.cached_plans()


def test_interface_distrib_and_counts(monkeypatch):
    iface = rt.generate_fft_interface(3, np.complex64, np.complex64,
                                      device="cpu")
    # a distributed plan is built over the torch.distributed world, and
    # this process has none (tests/test_torch_port_distributed.py runs it
    # on gloo ranks)
    with pytest.raises(RuntimeError, match="init_distributed"):
        iface.make_plan_distrib((8, 8, 8))
    assert iface.get_num_nodes() == 1
    assert iface.get_num_local_devices() == torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rt.FFTInterface.get_num_local_devices() == 4
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    assert rt.FFTInterface.get_num_nodes() == 2


# --- workers ---------------------------------------------------------------
def test_workers_api_parity():
    """scipy.fft.set_workers / get_workers analog (advisory), as
    tests/test_measure.py:293 holds the JAX package's."""
    assert rt.get_workers() == 1
    with rt.set_workers(4) as w:
        assert w == 4 and rt.get_workers() == 4
        with rt.set_workers(2):
            assert rt.get_workers() == 2
        assert rt.get_workers() == 4
    assert rt.get_workers() == 1
    with pytest.raises(ValueError):
        rt.set_workers(0)


# --- core_fn and the verify helpers ----------------------------------------
def test_core_fn_is_the_split_plane_core():
    c = rt.make_plan((4, 64), axes=(1,), device="cpu")
    assert c.core_fn == c.execute_split
    r = rt.make_plan((4, 64), axes=(1,), kind="r2c", device="cpu")
    assert r.core_fn == r.execute_real
    x = RNG.standard_normal((4, 64)).astype(np.float32)
    yr, yi = r.core_fn(torch.from_numpy(x))
    assert rel_l2(torch.complex(yr, yi), np.fft.rfft(x)) <= tolerance(64)


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward", "none"])
@pytest.mark.parametrize("shape,axes,kind,direction", [
    ((6, 1009), (1,), "c2c", -1), ((6, 1009), (1,), "c2c", 1),
    ((4, 8, 12), (0, 1, 2), "c2c", -1), ((5, 514), (1,), "r2c", -1),
    ((5, 2018), (1,), "c2r", 1), ((3, 8, 16), (1, 2), "c2r", 1)])
def test_verify_plan_equals_jax(shape, axes, kind, direction, norm):
    """The port's verify_plan on its plan against the JAX verify_plan on the
    JAX plan: both ok, both errors within the bound, on the same seeded
    input."""
    p = rt.make_plan(shape, axes=axes, kind=kind, direction=direction,
                     norm=norm, device="cpu")
    jp = R.make_plan(shape, axes=axes, kind=R.Kind(kind),
                     direction=R.Direction(direction), norm=R.Norm(norm))
    t = tverify.verify_plan(p, seed=3)
    j = jverify.verify_plan(jp, seed=3)
    assert t["tol"] == j["tol"] == tolerance(p.spec.logical_n)
    assert t["ok"] and j["ok"], (t, j)
    # the same input through the port's helper with an explicit x
    x = (RNG.standard_normal(shape).astype(np.float32) if kind == "r2c"
         else None)
    if x is not None:
        assert tverify.verify_plan(p, x=x)["ok"]


def test_verify_plan_complex32_and_complex128():
    for dtype in ("complex32", "complex128"):
        p = rt.make_plan((4, 1031), axes=(1,), dtype=dtype, device="cpu")
        res = tverify.verify_plan(p, seed=1)
        assert res["tol"] == tolerance(1031, dtype) and res["ok"], res


@pytest.mark.parametrize("n", [64, 1009, 2053])
def test_check_parseval_equals_jax(n):
    f = rt.make_plan((n,), device="cpu")
    jf = R.make_plan((n,), kind=R.Kind.C2C, direction=R.Direction.FORWARD)
    t = tverify.check_parseval(f, n, seed=2)
    j = jverify.check_parseval(jf, n, seed=2)
    assert t <= tolerance(n) and j <= tolerance(n)
    assert tverify._fwd_scale(f.spec) == jverify._fwd_scale(jf.spec)
    assert tverify._np_norm_undo(f.spec) == jverify._np_norm_undo(jf.spec)


def test_new_names_are_exported():
    for name in ("IODim", "GuruPlan", "plan_guru", "plan_many",
                 "FFTInterface", "generate_fft_interface", "fftshift",
                 "ifftshift", "fftfreq", "rfftfreq", "set_workers",
                 "get_workers", "prev_fast_len"):
        assert hasattr(rt, name) and hasattr(R, name), name
    assert rt.prev_fast_len(1009) == R.prev_fast_len(1009) == 1000
