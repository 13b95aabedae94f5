"""The port's uneven (non-divisible) slab plans on 5 gloo ranks, a prime
count, against the JAX package's on the first 5 of its 8 virtual CPU
devices and numpy in float64.

Mirrors the C2C tests of ``tests/test_distributed_uneven.py``: FFTW's
default block ceil(n/P) with short or empty last blocks
(``mpi/block.c:39``), padded inside the plan; the pencil ones need a 2-D
mesh and are in ``test_torch_port_distributed_p8.py``; the real uneven
plans in ``test_torch_port_distributed_real.py`` (8 ranks) and
``test_torch_port_distributed_r2r.py`` (5 ranks).
"""
import numpy as np
import pytest

from regent_fft_tpu.dtypes import Direction, Kind, Norm
from regent_fft_tpu.parallel import distributed as jdist
from regent_fft_tpu_torch.parallel import distributed as pdist
from torch_dist_ref import (agree, assemble, chain, crand, fft_mesh, jax_np,
                            jax_blocks, pool_fixture, port_blocks, run)

P = 5
pool = pool_fixture(P)
B = Direction.BACKWARD


def rng(seed):
    return np.random.default_rng(seed)


def _slab(x, shape, **kw):
    return jdist.make_plan_slab(shape, mesh=fft_mesh(P), **kw)


# the JAX test's shapes, but (100, 3, 20), which 5 divides: (99, 3, 21)
@pytest.mark.parametrize("shape", [(10, 4, 12), (99, 3, 21), (9, 5, 7)])
def test_slab_uneven(pool, shape):
    x = crand(rng(1), shape)
    j = _slab(x, shape, norm=Norm.NONE)
    y, f = run(pool, "make_plan_slab", x, shape, norm=Norm.NONE)
    assert "uneven blocks" in f["description"]
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_slab_uneven_roundtrip(pool):
    shape = (12, 4, 10)
    x = crand(rng(2), shape)
    res = chain(pool, [("make_plan_slab", (shape,), dict(norm=Norm.NONE)),
                       ("make_plan_slab", (shape,),
                        dict(direction=B, norm=Norm.BACKWARD))], x)
    jy = _slab(x, shape, norm=Norm.NONE)(x)
    jb = _slab(x, shape, direction=B, norm=Norm.BACKWARD)(jy)
    agree(assemble(res, 1), jax_np(jb), x, x.size)


def test_slab_uneven_transposed_pair(pool):
    shape = (10, 4, 6)
    x = crand(rng(3), shape)
    f = dict(transposed_out=True, norm=Norm.NONE)
    b = dict(direction=B, transposed_in=True, norm=Norm.BACKWARD)
    res = chain(pool, [("make_plan_slab", (shape,), f),
                       ("make_plan_slab", (shape,), b)], x)
    jy = _slab(x, shape, **f)(x)
    agree(assemble(res, 0), jax_np(jy), np.fft.fftn(x.astype(np.complex128)),
          x.size)
    agree(assemble(res, 1), jax_np(_slab(x, shape, **b)(jy)), x, x.size)


def test_slab_uneven_2d(pool):
    x = crand(rng(4), (10, 12))
    j = _slab(x, (10, 12), norm=Norm.NONE)
    y, _ = run(pool, "make_plan_slab", x, (10, 12), norm=Norm.NONE)
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_slab_uneven_howmany(pool):
    shape = (6, 4, 10)
    xb = crand(rng(5), (3,) + shape)
    j = _slab(xb, shape, howmany=3, norm=Norm.NONE)
    y, _ = run(pool, "make_plan_slab", xb, shape, howmany=3, norm=Norm.NONE)
    agree(y, jax_np(j(xb)),
          np.fft.fftn(xb.astype(np.complex128), axes=(1, 2, 3)), xb.size)


def test_slab_uneven_chunked(pool):
    shape = (12, 6, 10)
    x = crand(rng(6), shape)
    j = _slab(x, shape, pipeline_chunks=2, norm=Norm.NONE)
    y, f = run(pool, "make_plan_slab", x, shape, pipeline_chunks=2,
               norm=Norm.NONE)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_auto_dispatch_no_longer_raises(pool):
    shape = (6, 5, 10)
    x = crand(rng(7), shape)
    j = jdist.make_plan_distributed(shape, norm=Norm.NONE, n_devices=P)
    y, f = run(pool, "make_plan_distributed", x, shape, norm=Norm.NONE)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_prime_device_count(pool):
    shape = (9, 4, 7)
    x = crand(rng(8), shape)
    j = _slab(x, shape, norm=Norm.NONE)
    y, _ = run(pool, "make_plan_slab", x, shape, norm=Norm.NONE)
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_candidates_offer_padded_modes():
    for cand in (jdist.candidate_strategies, pdist.candidate_strategies):
        cands = cand((10, 5, 9), 8)
        modes = {c["mode"] for c in cands}
        assert "slab" in modes and "pencil" in modes
    assert pdist.candidate_strategies((10, 5, 9), 8) == \
        jdist.candidate_strategies((10, 5, 9), 8)
    for kind in (Kind.R2C, Kind.C2R):
        got = pdist.candidate_strategies((10, 5, 8), 8,
                                         kind=pdist.Kind(kind.value))
        assert got == jdist.candidate_strategies((10, 5, 8), 8, kind=kind)
        assert {c["mode"] for c in got} >= {"slab", "pencil"}


def test_divisible_shapes_stay_exact(pool):
    shape = (15, 4, 10)
    x = crand(rng(9), shape)
    j = _slab(x, shape, norm=Norm.NONE)
    y, f = run(pool, "make_plan_slab", x, shape, norm=Norm.NONE)
    assert "uneven" not in f["description"]
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


@pytest.mark.parametrize("kw", [{}, dict(transposed_out=True),
                                dict(transposed_in=True)],
                         ids=["natural", "transposed_out", "transposed_in"])
def test_slab_empty_blocks(pool, kw):
    """Port-only: 3 planes over 5 ranks (blocks of 1, the last two
    empty), a last axis of 7 (blocks of 2, the last empty); the blocks are
    the JAX plan's shardings and the output is right."""
    shape = (3, 4, 7)
    x = crand(rng(10), shape)
    j = _slab(x, shape, norm=Norm.NONE, **kw)
    res = chain(pool, [("make_plan_slab", (shape,),
                        dict(norm=Norm.NONE, **kw))], x)
    f = res[0][0]
    assert port_blocks(f["in_blocks"]) == jax_blocks(j, j.in_sharding, shape)
    assert port_blocks(f["out_blocks"]) == jax_blocks(j, j.out_sharding,
                                                      shape)
    sizes = [np.prod([s.stop - s.start for s in b]) for b in f["in_blocks"]]
    assert sizes.count(0) == (1 if kw.get("transposed_in") else 2)
    agree(assemble(res), jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)),
          x.size)
