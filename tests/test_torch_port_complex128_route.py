"""The complex128 route on the card, planned on the host.

A complex128 plan whose device is CUDA plans one ``stockham`` step on
each axis that the f64 instances of ``fft_cols``/``fft_last`` take (powers
of two 2..1024, ``f64_len_ok``) and the contraction steps elsewhere, and
nothing fused: no ``stockham2``, gap, ring or four-step step.  The same
spec on the CPU keeps the JAX package's contraction route, and the
complex64 and complex32 step lists do not change.  ``axis_steps`` and
``route_steps`` need no card for that: they are called with a CUDA device
and never touch it.  The step list then runs here on CPU planes (the f64
plain versions, the kernels' arithmetic) and is held against numpy.
"""
import numpy as np
import pytest
import torch

from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.dtypes import Direction, Kind, Norm
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _spec(shape, dtype, direction=Direction.FORWARD, **kw):
    return tplan.PlanSpec(shape=tuple(shape), axes=tuple(range(len(shape))),
                          kind=Kind.C2C, direction=direction, dtype=dtype,
                          device="cpu", **kw)


def _steps(shape, dtype, device, backend="hybrid", gap_fused=False,
           switches=None, **kw):
    spec = _spec(shape, dtype, **kw)
    steps = tplan.axis_steps(spec, backend, sorted(spec.axes, reverse=True),
                             gap_fused, device)
    steps = tplan.route_steps(spec, steps, list(shape),
                              switches or tplan.Switches())
    return [(k, a, arg if not callable(arg) else "fn") for k, a, arg in steps]


@pytest.mark.parametrize("backend", ["hybrid", "stockham"])
@pytest.mark.parametrize("shape,want", [
    # NPB FT class C: the three axes on the f64 column and row kernels
    ((512, 512, 512), [("stockham", 2, 512), ("stockham", 1, 512),
                       ("stockham", 0, 512)]),
    ((64, 1024), [("stockham", 1, 1024), ("stockham", 0, 64)]),
    ((16, 128, 128, 128), [("stockham", 3, 128), ("stockham", 2, 128),
                           ("stockham", 1, 128), ("stockham", 0, 16)]),
    # no f64 instance past 1024 or off the powers of two: contractions
    ((2048, 64), [("stockham", 1, 64), ("mixed2", 0, (2048, 64))]),
    ((96, 32), [("stockham", 1, 32), ("direct", 0, 96)]),
    ((384, 512), [("stockham", 1, 512), ("direct", 0, 384)]),
])
def test_cuda_complex128_plans_stockham_steps(shape, want, backend):
    assert _steps(shape, "complex128", CUDA, backend) == want


@pytest.mark.parametrize("switches", [
    tplan.Switches(), tplan.Switches(gap_fused=True),
    tplan.Switches(axis0_impl="fourstep", dma_min_post=1),
    tplan.Switches(axis0_impl="dma", dma_min_post=1),
    tplan.Switches(f2_impl="ring")])
def test_cuda_complex128_fuses_nothing(switches):
    """No switch brings a fused, gap, ring or four-step step into a
    complex128 plan: those kernels have no f64 instance."""
    got = _steps((512, 512, 512), "complex128", CUDA, "stockham",
                 gap_fused=switches.gap_fused, switches=switches)
    assert got == [("stockham", 2, 512), ("stockham", 1, 512),
                   ("stockham", 0, 512)]
    assert _steps((4, 256, 256, 256), "complex128", CUDA, "stockham",
                  gap_fused=switches.gap_fused, switches=switches) == [
        ("stockham", 3, 256), ("stockham", 2, 256), ("stockham", 1, 256),
        ("stockham", 0, 4)]


@pytest.mark.parametrize("shape", [(512, 512, 512), (64, 1024), (2048, 64),
                                   (4, 8, 16)])
@pytest.mark.parametrize("backend", ["hybrid", "stockham", "xla"])
def test_cpu_complex128_keeps_the_contraction_route(shape, backend):
    got = _steps(shape, "complex128", CPU, backend)
    assert got and not any(tplan.STEPS[k].kernel for k, _, _ in got)
    if backend == "xla":     # and the card's xla route takes no kernel
        assert _steps(shape, "complex128", CUDA, backend) == got


@pytest.mark.parametrize("dtype", ["complex64", "complex32"])
@pytest.mark.parametrize("shape,want", [
    ((512, 512, 512), [("stockham2", 1, (512, 512)), ("stockham", 0, 512)]),
    ((64, 1024), [("stockham2", 0, (64, 1024))]),
    ((2048, 64), [("stockham", 1, 64), ("stockham", 0, 2048)]),
    ((96, 32), [("stockham", 1, 32), ("direct", 0, 96)]),
    ((4, 8, 16), [("stockham", 2, 16), ("stockham", 1, 8),
                  ("stockham", 0, 4)]),
])
def test_complex64_and_complex32_routes_unchanged(shape, want, dtype):
    """The f32 and bf16 step lists are those of the JAX package, on either
    device."""
    for dev in (CUDA, CPU):
        assert _steps(shape, dtype, dev) == want


def test_f64_plan_prefetches_float64_tables_of_its_kernels():
    """The table prefetch of a complex128 plan on the card names the row
    kernel's list for the last axis and the column kernel's for the others
    (the plan uploads them as float64 tables)."""
    spec = _spec((512, 512, 512), "complex128")
    steps = tplan.axis_steps(spec, "hybrid", [2, 1, 0], False, CUDA)
    got = [(n, f.__name__, dt) for n, f, dt in
           tplan.kernel_keys(steps, (512, 512, 512), torch.float64)]
    assert got == [(512, "last_stages", torch.float64),
                   (512, "cols_stages", torch.float64),
                   (512, "cols_stages", torch.float64)]


@pytest.mark.parametrize("norm", [Norm.BACKWARD, Norm.ORTHO])
@pytest.mark.parametrize("shape", [(16, 32, 64), (8, 1024), (4, 24, 16)])
def test_cuda_route_runs_on_host_planes(shape, norm):
    """The card's complex128 step list, run on CPU f64 planes (the plain
    versions of the f64 kernels), gives numpy's transform within
    tolerance(N, "complex128"), with the norm scale riding the last kernel
    step's write."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for direction in (Direction.FORWARD, Direction.BACKWARD):
        spec = _spec(shape, "complex128", direction, norm=norm)
        steps = tplan.axis_steps(spec, "hybrid", sorted(spec.axes,
                                                        reverse=True),
                                 False, CUDA)
        scale = tplan._norm_scale(spec)
        fused = tplan.STEPS[steps[-1][0]].kernel
        yr, yi = tplan.run_steps(steps, torch.from_numpy(x.real.copy()),
                                 torch.from_numpy(x.imag.copy()), direction,
                                 False, fuse_scale=scale if fused else 1.0)
        assert yr.dtype == torch.float64
        y = yr.numpy() + 1j * yi.numpy()
        if not fused:
            y = y * scale
        ref = (np.fft.fftn(x) if direction == Direction.FORWARD
               else np.fft.ifftn(x, norm="forward")) * scale
        assert rel_l2(y, ref) <= tolerance(int(np.prod(shape)), "complex128")


@pytest.mark.parametrize("n", [2048, 384, 640])
def test_f64_planes_refuse_lengths_without_an_instance(n):
    x = torch.zeros(4, n, dtype=torch.float64)
    with pytest.raises(ValueError, match="f64 kernels"):
        sk.fft_axis_stockham(x, x, -1, Direction.FORWARD)
