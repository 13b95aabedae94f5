"""complex32 (bf16 planes) on the leading-axis routes of the port -- the
two-stage four-step (``fft_axis0_fourstep``), the slab ring
(``fft_axis_dma``) and the fused ring (``fft_axes2_ring``) -- against the
JAX package's Pallas entries in interpret mode on the CPU.

Inputs are made with numpy from a seed and rounded to bf16 once, so both
packages and the float64 reference see the same values.  Bound:
``tolerance(n, "complex32")`` between the packages and for each against
numpy in float64.  The JAX four-step runs its bf16 stages as 'hd' dots
(one bf16 pass, tables rounded to bf16); the port's plain versions
compute the stages in f32 and round each stage's output to bf16, as the
CUDA kernels do.  Where r1 < 16 both packages run the four-step on f32
planes and return f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch.dtypes import Direction, SplitComplex
from regent_fft_tpu_torch.ops import fourstep as fs
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _planes(shape, seed):
    """(torch bf16 planes, jax bf16 planes, the bf16-rounded complex128)."""
    rng = np.random.default_rng(seed)
    tr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ti = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tr, ti = tr.to(torch.bfloat16), ti.to(torch.bfloat16)
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    return ((tr, ti), (jnp.asarray(tr.float().numpy(), jnp.bfloat16),
                       jnp.asarray(ti.float().numpy(), jnp.bfloat16)), xd)


def _cplx(a, b):
    return (np.asarray(jnp.asarray(a, jnp.float32), np.float64)
            + 1j * np.asarray(jnp.asarray(b, jnp.float32), np.float64))


def _run(port_fn, jax_fn, shape, seed, axes, direction, scale, n,
         out=torch.bfloat16):
    """Both packages on the same bf16 planes; the port's CPU planes must
    launch nothing; the output dtype is JAX's."""
    (tr, ti), (jr, ji), xd = _planes(shape, seed)
    before = dict(sk.LAUNCHES)
    yr, yi = port_fn(tr, ti)
    assert sk.LAUNCHES == before
    zr, zi = jax_fn(jr, ji)
    assert yr.dtype == yi.dtype == out and zr.dtype == JDT[out]
    assert tuple(yr.shape) == shape
    y = SplitComplex(yr, yi)
    jy = _cplx(zr, zi)
    ref = (np.fft.fftn(xd, axes=axes) if int(direction) < 0
           else np.fft.ifftn(xd, axes=axes, norm="forward")) * scale
    tol = tolerance(n, "complex32")
    assert rel_l2(y, jy) <= tol
    assert rel_l2(y, ref) <= tol
    assert rel_l2(jy, ref) <= tol


# --- entries against the JAX package ------------------------------------------
@pytest.mark.parametrize("shape,axis,direction,scale,out", [
    # 'hd' stages on both sides (r1 = r2 = 16)
    ((256, 8, 128), 0, Direction.FORWARD, 1.0, torch.bfloat16),
    ((2, 256, 8, 128), 1, Direction.FORWARD, 1.0, torch.bfloat16),
    ((256, 8, 128), 0, Direction.BACKWARD, 1.0 / 256, torch.bfloat16),
    # r1 = 8: both packages run f32 planes and return them
    ((128, 8, 128), 0, Direction.FORWARD, 1.0, torch.float32),
    ((2, 64, 16, 256), 1, Direction.FORWARD, 1.0, torch.float32),
])
def test_axis0_fourstep_bf16_matches_jax(shape, axis, direction, scale, out):
    n = shape[axis]
    assert sk.axis0_fourstep_supported(
        n, int(np.prod(shape[axis + 1:])), shape[-1])
    assert (sk._a0fs_split(n)[0] >= 16) == jps.axis0_fourstep_hd(n)
    _run(lambda a, b: fs.fft_axis0_fourstep(a, b, axis, direction, scale),
         lambda a, b: jps.fft_axis0_fourstep(a, b, axis,
                                             JDirection(int(direction)),
                                             scale, k=2, interpret=True),
         shape, 5, (axis,), direction, scale, n, out)


@pytest.mark.parametrize("shape,axis", [((64, 8, 512), 0), ((2, 64, 2048), 1)])
def test_axis_dma_bf16_matches_jax(shape, axis):
    _run(lambda a, b: fs.fft_axis_dma(a, b, axis, Direction.FORWARD),
         lambda a, b: jps.fft_axis_dma(a, b, axis, JDirection.FORWARD, k=2,
                                       interpret=True),
         shape, 6, (axis,), Direction.FORWARD, 1.0, shape[axis])


@pytest.mark.parametrize("shape,direction,scale", [
    ((2, 32, 256), Direction.FORWARD, 1.0),
    ((2, 3, 32, 256), Direction.FORWARD, 1.0),
    ((2, 32, 256), Direction.BACKWARD, 1.0 / (32 * 256)),
])
def test_axes2_ring_bf16_matches_jax(shape, direction, scale):
    _run(lambda a, b: fs.fft_axes2_ring(a, b, direction, scale),
         lambda a, b: jps.fft_axes2_ring(a, b, JDirection(int(direction)),
                                         scale, k=2, interpret=True),
         shape, 7, (-2, -1), direction, scale, shape[-2] * shape[-1])


# --- the plain versions on bf16 planes -----------------------------------------
@pytest.mark.parametrize("sign", [-1, 1])
def test_a0fs_stages_bf16_round_each_stage(sign):
    """Each bf16 stage is the f32 stage of the bf16 input, rounded once to
    bf16; the stages compose to the FFT along the middle axis."""
    (tr, ti), _, xd = _planes((2, 512, 24), 8)
    ar, ai = fs.a0fs_stage("a", tr, ti, sign)
    assert ar.dtype == ai.dtype == torch.bfloat16 and ar.is_contiguous()
    fr, fi = fs.a0fs_stage("a", tr.float(), ti.float(), sign)
    assert torch.equal(ar, fr.to(torch.bfloat16))
    assert torch.equal(ai, fi.to(torch.bfloat16))
    yr, yi = fs.a0fs_stage("b", ar, ai, sign, 0.5)
    gr, gi = fs.a0fs_stage("b", ar.float(), ai.float(), sign, 0.5)
    assert torch.equal(yr, gr.to(torch.bfloat16))
    ref = (np.fft.fft(xd, axis=1) if sign < 0
           else np.fft.ifft(xd, axis=1) * 512) * 0.5
    assert rel_l2(SplitComplex(yr, yi), ref) <= tolerance(512, "complex32")


def test_ring_bf16_plain_is_the_grid_plain():
    """The ring's bf16 bodies are those of fft_cols / fft_fused2 (the JAX
    runner's _tile_impl choice), with the output in bf16."""
    (tr, ti), _, _ = _planes((3, 512, 128), 12)
    for fuse, grid in ((False, sk.fft_cols), (True, sk.fft_fused2)):
        r = fs.fft_axis_ring(tr, ti, -1, 0.5, fuse_last=fuse)
        c = grid(tr, ti, -1, 0.5)
        assert r[0].dtype == torch.bfloat16
        assert torch.equal(r[0], c[0]) and torch.equal(r[1], c[1])


def test_bf16_entries_keep_their_gates():
    z = torch.zeros
    b = torch.bfloat16
    with pytest.raises(ValueError):
        fs.fft_axis0_fourstep(z(32, 8, 256, dtype=b), z(32, 8, 256, dtype=b),
                              0, Direction.FORWARD)
    with pytest.raises(ValueError):
        fs.fft_axis_dma(z(8, 8, 128, dtype=b), z(8, 8, 128, dtype=b), 0,
                        Direction.FORWARD)
    with pytest.raises(ValueError):
        fs.fft_axes2_ring(z(2, 8, 512, dtype=b), z(2, 8, 512, dtype=b),
                          Direction.FORWARD)
    with pytest.raises(ValueError, match="float64"):
        fs.fft_axis_ring(z(2, 64, 128, dtype=torch.float64),
                         z(2, 64, 128, dtype=torch.float64), -1)


# --- complex32 plans on each explicit route -----------------------------------
def _lines(plan):
    return [ln.strip() for ln in plan.describe().splitlines()
            if ln.startswith("  (axis")]


@pytest.mark.parametrize("shape,axes,fields,want", [
    ((256, 8, 128), (0, 1, 2), dict(axis0_impl="fourstep"),
     ["(axis 2: kernel-butterfly(n=128))", "(axis 1: kernel-butterfly(n=8))",
      "(axis 0: kernel-fourstep-ring(n=256))"]),
    ((2, 64, 16, 256), (1, 2, 3), dict(axis0_impl="dma"),
     ["(axis 2: kernel-fused2(16, 256))", "(axis 1: kernel-dma-ring(n=64))"]),
])
def test_complex32_route_plans_below_the_post_gate(monkeypatch, shape, axes,
                                                   fields, want):
    """With the trailing-extent gate lowered (DMA_MIN_POST, the JAX
    package's REGENT_FFT_DMA_MIN_POST), small complex32 plans take the
    routes and keep bf16 planes through the bf16 stages."""
    monkeypatch.setattr(rt.plan, "DMA_MIN_POST", 1024)
    rt.clear_plan_cache()
    p = rt.make_plan(shape, axes=axes, backend="stockham", dtype="complex32",
                     device="cpu", **fields)
    assert _lines(p) == want
    (tr, ti), _, xd = _planes(shape, 31)
    y = p(SplitComplex(tr, ti))
    assert isinstance(y, SplitComplex) and y.re.dtype == torch.bfloat16
    tol = tolerance(p.spec.logical_n, "complex32")
    assert rel_l2(y, np.fft.fftn(xd, axes=axes)) <= tol
    back = p.inverse()(y)
    assert isinstance(back, SplitComplex) and back.re.dtype == torch.bfloat16
    assert rel_l2(back, xd) <= 2 * tol
    rt.clear_plan_cache()
