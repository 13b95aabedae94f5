"""The port's distributed plans on 4 gloo ranks, against the JAX package's
on the first 4 of its 8 virtual CPU devices and numpy in float64.

Mirrors the C2C tests of ``tests/test_distributed.py`` (all but the packed
C2R one, a single-device plan), ``tests/test_distributed_extra.py``
(rank-1, transpose, howmany) and the per-shard real tests of
``tests/test_distributed_real.py``; the 2 x 4 pencils, the fuzz and
``dryrun_multichip`` are in ``test_torch_port_distributed_p8.py``, the
prime and uneven slabs in ``test_torch_port_distributed_uneven.py``, the
real global plans in ``test_torch_port_distributed_real.py`` and the
rank-1 real, r2r and real-race tests in
``test_torch_port_distributed_r2r.py``.  Each
test makes its input from a numpy seed, runs the JAX plan on it, sends it
to the ranks (each takes its ``in_block``), assembles the port's output
from the ``out_block``s and holds it to the JAX output and to numpy within
``tolerance(n, dtype)``.  Port-only: the exchange's block order at P = 4,
bf16 exchange buffers for complex32, the strategy race under rank-dependent
times, the "distrib" wisdom and its gather/broadcast, a CUDA plan on a gloo
group, collective logging, and every plan kind's blocks against the JAX
plan's shardings.
"""
import json
from collections import namedtuple

import numpy as np
import pytest

import regent_fft_tpu as R
import regent_fft_tpu_torch as rt
from regent_fft_tpu.dtypes import Direction, Kind, Norm
from regent_fft_tpu.parallel import distributed as jdist
from regent_fft_tpu_torch.parallel import distributed as pdist
from regent_fft_tpu_torch.parallel import mesh as pmesh
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance
from torch_dist_ref import (agree, assemble, chain, crand, fft_mesh, jax_np,
                            jax_blocks, pencil_mesh, pool_fixture,
                            port_blocks, run)

P = 4
pool = pool_fixture(P)
M1 = fft_mesh  # JAX 1-D mesh over the first P devices
F, B = Direction.FORWARD, Direction.BACKWARD


def rng(seed):
    return np.random.default_rng(seed)


# --- tests/test_distributed.py -------------------------------------------
def test_shards_reference_parity(pool):
    x = crand(rng(1), (8, 4, 16))
    j = jdist.make_plan_shards((8, 4, 16), direction=F, mesh=M1(P))
    y, f = run(pool, "make_plan_shards", x, (8, 4, 16), direction=F)
    ref = np.fft.fftn(x.reshape(P, 2, 4, 16), axes=(1, 2, 3)).reshape(x.shape)
    agree(y, jax_np(j(x)), ref, 2 * 64)
    assert "no collectives" in f["description"]


def test_slab_2d(pool):
    x = crand(rng(2), (16, 24))
    j = jdist.make_plan_slab((16, 24), mesh=M1(P))
    y, _ = run(pool, "make_plan_slab", x, (16, 24))
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_slab_3d_and_inverse(pool):
    x = crand(rng(3), (16, 8, 16))
    fwd = ("make_plan_slab", ((16, 8, 16),), {})
    inv = ("make_plan_slab", ((16, 8, 16),),
           dict(direction=B, norm=Norm.BACKWARD))
    res = chain(pool, [fwd, inv], x)
    jy = jax_np(jdist.make_plan_slab((16, 8, 16), mesh=M1(P))(x))
    agree(assemble(res, 0), jy, np.fft.fftn(x), x.size)
    jback = jax_np(jdist.make_plan_slab((16, 8, 16), mesh=M1(P), direction=B,
                                        norm=Norm.BACKWARD)(jy))
    agree(assemble(res, 1), jback, x, x.size)


def test_slab_transposed_out(pool):
    x = crand(rng(4), (8, 8, 8))
    j = jdist.make_plan_slab((8, 8, 8), mesh=M1(P), transposed_out=True)
    y, f = run(pool, "make_plan_slab", x, (8, 8, 8), transposed_out=True)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)
    assert f["out_spec"][-1] == "fft" == j.out_sharding.spec[-1]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 1)])
def test_pencil_3d(pool, mesh_shape):
    x = crand(rng(5), (8, 8, 16))
    j = jdist.make_plan_pencil((8, 8, 16), mesh=pencil_mesh(mesh_shape))
    y, _ = run(pool, "make_plan_pencil", x, (8, 8, 16), mesh_shape=mesh_shape)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_pencil_transposed_out(pool):
    x = crand(rng(6), (4, 8, 8))
    j = jdist.make_plan_pencil((4, 8, 8), mesh=pencil_mesh((2, 2)),
                               transposed_out=True)
    y, f = run(pool, "make_plan_pencil", x, (4, 8, 8), mesh_shape=(2, 2),
               transposed_out=True)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)
    assert f["out_spec"] == (None, "fy", "fz")


def test_pencil_inverse_roundtrip(pool):
    x = crand(rng(7), (8, 8, 8))
    kw = dict(mesh_shape=(2, 2))
    res = chain(pool, [("make_plan_pencil", ((8, 8, 8),), kw),
                       ("make_plan_pencil", ((8, 8, 8),),
                        dict(kw, direction=B))], x)
    m = pencil_mesh((2, 2))
    jy = jax_np(jdist.make_plan_pencil((8, 8, 8), mesh=m)(x))
    jb = jax_np(jdist.make_plan_pencil((8, 8, 8), mesh=m, direction=B)(jy))
    agree(assemble(res, 1), jb, x, x.size)


def test_slab_non_divisible_uses_uneven_blocks(pool):
    x = crand(rng(8), (9, 8, 8))
    j = jdist.make_plan_slab((9, 8, 8), mesh=M1(P), norm=Norm.NONE)
    y, f = run(pool, "make_plan_slab", x, (9, 8, 8), norm=Norm.NONE)
    assert "uneven blocks" in f["description"]
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_interface_make_plan_distrib(pool):
    x = crand(rng(9), (8, 4, 16))
    jp = R.generate_fft_interface(2, np.complex64, np.complex64
                                  ).make_plan_distrib((8, 4, 16), mesh=M1(P))
    y, _ = run(pool, "interface", x, (2, np.complex64, np.complex64),
               (8, 4, 16))
    ref = np.fft.fftn(x.reshape(P, 2, 4, 16), axes=(1, 2, 3)).reshape(x.shape)
    agree(y, jax_np(jp(x)), ref, 2 * 64)
    err = pool.run("destroyed_call", "interface",
                   ((2, np.complex64, np.complex64), (8, 4, 16)), {}, x)
    assert all(e[0] == "RuntimeError" for e in err), err


def test_shards_full_local_transform(pool):
    x = crand(rng(10), (16, 4))
    j = jdist.make_plan_shards((16, 4), direction=F, mesh=M1(P))
    y, _ = run(pool, "make_plan_shards", x, (16, 4), direction=F)
    ref = np.fft.fftn(x.reshape(P, 4, 4), axes=(1, 2)).reshape(16, 4)
    agree(y, jax_np(j(x)), ref, 16)


def test_shards_1d_local_chunks(pool):
    x = crand(rng(11), (16,))
    j = jdist.make_plan_shards((16,), direction=F, mesh=M1(P))
    y, _ = run(pool, "make_plan_shards", x, (16,), direction=F)
    ref = np.fft.fft(x.reshape(P, 4), axis=1).reshape(16)
    agree(y, jax_np(j(x)), ref, 4)


def test_slab_pipelined_chunks_matches(pool):
    x = crand(rng(12), (8, 6, 16))
    ref = np.fft.fftn(x)
    for chunks in (2, 3):
        j = jdist.make_plan_slab((8, 6, 16), mesh=M1(P), norm=Norm.NONE,
                                 pipeline_chunks=chunks)
        y, f = run(pool, "make_plan_slab", x, (8, 6, 16), norm=Norm.NONE,
                   pipeline_chunks=chunks)
        agree(y, jax_np(j(x)), ref, x.size)
        assert f"pipelined x{chunks}" in f["description"]
        assert f["description"] == j.description


def test_pencil_pipelined_chunks_matches(pool):
    x = crand(rng(13), (8, 8, 16))
    j = jdist.make_plan_pencil((8, 8, 16), mesh=pencil_mesh((2, 2)),
                               norm=Norm.NONE, pipeline_chunks=2)
    y, f = run(pool, "make_plan_pencil", x, (8, 8, 16), mesh_shape=(2, 2),
               norm=Norm.NONE, pipeline_chunks=2)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)
    assert f["description"] == j.description


def test_collective_logging_level2(pool):
    x = np.ones((8, 4, 16), np.complex64)
    out = pool.run("logged_chain", [("make_plan_slab", ((8, 4, 16),),
                                     dict(norm=Norm.NONE))], x)
    for m in (o["records"] for o in out):
        a2a = [s for s in m if s.startswith("collective all_to_all")]
        # two exchanges a call, each with its axis and local shape
        assert len(a2a) == 2, m
        assert "over axis 'fft', local shape (2, 4, 16)" in a2a[0]
        assert any("make_plan" in s for s in m)


def test_distributed_donate(pool):
    x = crand(rng(14), (16, 8, 16))
    y, _ = run(pool, "make_plan_slab", x, (16, 8, 16), donate=True)
    jy = jax_np(jdist.make_plan_slab((16, 8, 16), mesh=M1(P),
                                     donate=True)(x))
    agree(y, jy, np.fft.fftn(x.astype(np.complex128)), x.size)
    xr = rng(14).standard_normal((16, 8, 16)).astype(np.float32)
    y, f = run(pool, "make_plan_slab_r2c", xr, (16, 8, 16), donate=True)
    assert y.shape == (16, 8, 9) and y.dtype == np.complex64
    jr = jdist.make_plan_slab_r2c((16, 8, 16), mesh=M1(P), donate=True)
    agree(y, jax_np(jr(xr)), np.fft.rfftn(xr.astype(np.float64)), xr.size)


def test_donate_reuses_the_input_planes(pool):
    """Port-only: with donate=True the first exchange unpacks into the
    caller's input planes (when they are the plan's contiguous f32 planes
    and the exchange's size), so the caller's planes are overwritten;
    without it they are never written.  The outputs agree."""
    shape = (16, 8, 16)
    outs = {}
    for donate in (False, True):
        res = pool.run("donate_check", shape, donate)
        assert all(r["overwritten"] == donate for r in res), donate
        got = np.zeros(shape, np.complex64)
        for r in res:
            got[r["out_block"]] = r["y"]
        outs[donate] = got
    np.testing.assert_array_equal(outs[True], outs[False])
    g = np.random.default_rng(0)
    x = g.standard_normal(shape) + 1j * g.standard_normal(shape)
    assert rel_l2(outs[True], np.fft.fftn(x)) <= tolerance(x.size)


def test_slab_transposed_in_chains_with_transposed_out(pool):
    shape = (16, 4, 16)
    x = crand(rng(15), shape)
    fwd = ("make_plan_slab", (shape,), dict(norm=Norm.NONE,
                                           transposed_out=True))
    inv = ("make_plan_slab", (shape,), dict(norm=Norm.BACKWARD, direction=B,
                                           transposed_in=True))
    res = chain(pool, [fwd, inv], x)
    jf = jdist.make_plan_slab(shape, mesh=M1(P), norm=Norm.NONE,
                              transposed_out=True)
    ji = jdist.make_plan_slab(shape, mesh=M1(P), norm=Norm.BACKWARD,
                              direction=B, transposed_in=True)
    jX = jax_np(jf(x))
    agree(assemble(res, 0), jX, np.fft.fftn(x), x.size)
    agree(assemble(res, 1), jax_np(ji(jX)), x, x.size)
    # standalone transposed_in forward is a global FFT too
    j = jdist.make_plan_slab(shape, mesh=M1(P), norm=Norm.NONE,
                             transposed_in=True)
    y, _ = run(pool, "make_plan_slab", x, shape, norm=Norm.NONE,
               transposed_in=True)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)
    err = pool.run("plan_error", "make_plan_slab", (shape,),
                   dict(transposed_in=True, transposed_out=True))
    assert all(e[0] == "ValueError" for e in err)


def test_slab_complex32_bf16_transport(pool):
    shape = (16, 32, 32)
    x = crand(rng(16), shape)
    j = jdist.make_plan_slab(shape, mesh=M1(P), norm=Norm.NONE,
                             dtype="complex32")
    y, f = run(pool, "make_plan_slab", x, shape, norm=Norm.NONE,
               dtype="complex32")
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)),
          int(np.prod(shape)), "complex32")
    assert f["dtype"] == "torch.bfloat16"


def test_complex32_exchanges_bf16_buffers(pool):
    """Port-only: every collective of a complex32 plan moves bf16, of a
    complex128 plan f64, of a complex64 plan f32 (one buffer holding
    both planes)."""
    shape = (8, 8, 8)
    for dtype, want in (("complex32", "torch.bfloat16"),
                        ("complex64", "torch.float32"),
                        ("complex128", "torch.float64")):
        out = pool.run("exchange_dtypes", shape, dtype)
        for o in out:
            assert o["dtypes"] == [want, want], (dtype, o["dtypes"])
            assert o["plane_dtype"] == want
        got = np.zeros(shape, np.complex128)
        for o in out:
            got[o["out_block"]] = o["y"]
        x = np.random.default_rng(0)
        xr = x.standard_normal(shape) + 1j * x.standard_normal(shape)
        ref = np.fft.fftn(xr.astype(np.complex64).astype(np.complex128))
        assert rel_l2(got, ref) <= tolerance(xr.size, dtype)


def test_pencil_complex32_bf16_transport(pool):
    shape = (8, 16, 32)
    x = crand(rng(17), shape)
    j = jdist.make_plan_pencil(shape, mesh=pencil_mesh((2, 2)),
                               norm=Norm.NONE, dtype="complex32")
    y, _ = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 2),
               norm=Norm.NONE, dtype="complex32")
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)),
          int(np.prod(shape)), "complex32")


def test_multislice_mesh_and_dcn_pencil(pool):
    from regent_fft_tpu.parallel.mesh import make_multislice_mesh
    m = pool.run("multislice", 2, 2)
    assert all(o == {"names": ("slice", "chip"), "shape": (2, 2),
                     "ranks": [[0, 1], [2, 3]]} for o in m), m
    shape = (8, 16, 16)
    x = crand(rng(18), shape)
    jm = make_multislice_mesh(2, 2, devices=__import__("jax").devices()[:P])
    j = jdist.make_plan_pencil(shape, mesh=jm, transposed_out=True,
                               pipeline_chunks2=2)
    y, f = run(pool, "make_plan_pencil", x, shape,
               mesh=("multislice", 2, 2), transposed_out=True,
               pipeline_chunks2=2)
    assert "a2a[slice]/2chunks" in f["description"]
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


def test_pencil_chunks2_matches_unchunked(pool):
    shape = (8, 8, 16)
    x = crand(rng(19), shape)
    base, _ = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 2))
    chunked, f = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 2),
                     pipeline_chunks2=2)
    assert "/2chunks" in f["description"]
    np.testing.assert_allclose(chunked, base, rtol=2e-6, atol=2e-6)
    j = jdist.make_plan_pencil(shape, mesh=pencil_mesh((2, 2)),
                               pipeline_chunks2=2)
    agree(chunked, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_multislice_mesh_rejects_oversubscription(pool):
    for args in ((8,), (2, 4), (0, 4)):
        out = pool.run("multislice", *args)
        assert all(o[0] == "ValueError" for o in out), (args, out)


def test_multislice_selection_spans_slices():
    D = namedtuple("D", ["id", "slice_index"])
    devs = [D(s * 8 + i, s) for s in range(2) for i in range(8)]
    for sel in (pmesh._select_multislice, R.parallel.mesh._select_multislice):
        arr = sel(devs, 2, 4)
        assert arr.shape == (2, 4)
        assert {d.slice_index for d in arr[0]} == {0}
        assert {d.slice_index for d in arr[1]} == {1}
        uneven = [D(i, 0) for i in range(8)] + [D(100, 1)] \
            + [D(200 + i, 2) for i in range(8)]
        assert [row[0].slice_index for row in sel(uneven, 2, 8)] == [0, 2]
        with pytest.raises(ValueError):
            sel(devs, 3, 8)
    # the port's ranks-as-devices select the same arrays
    ranks = [pmesh.RankDevice(d.id, d.slice_index) for d in devs]
    assert [[d.rank for d in row] for row in
            pmesh._select_multislice(ranks, 2, 4)] == \
        [[d.id for d in row] for row in
         R.parallel.mesh._select_multislice(devs, 2, 4)]


# --- tests/test_distributed_extra.py -------------------------------------
@pytest.mark.parametrize("n", [1 << 13, 5184, 1 << 16])
def test_slab_1d_forward(pool, n):
    x = crand(rng(20), n)
    j = jdist.make_plan_slab_1d(n, mesh=M1(P))
    y, f = run(pool, "make_plan_slab_1d", x, n)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fft(x), n)


def test_slab_1d_large(pool):
    n = 1 << 22
    x = crand(rng(21), n)
    j = jdist.make_plan_slab_1d(n, mesh=M1(P))
    y, _ = run(pool, "make_plan_slab_1d", x, n)
    agree(y, jax_np(j(x)), np.fft.fft(x), n)


def test_slab_1d_inverse_norm(pool):
    n = 1 << 12
    x = crand(rng(22), n)
    res = chain(pool, [("make_plan_slab_1d", (n,), {}),
                       ("make_plan_slab_1d", (n,),
                        dict(direction=B, norm=Norm.BACKWARD))], x)
    jf = jdist.make_plan_slab_1d(n, mesh=M1(P))
    jb = jdist.make_plan_slab_1d(n, mesh=M1(P), direction=B,
                                 norm=Norm.BACKWARD)
    agree(assemble(res, 1), jax_np(jb(jf(x))), x, n)


def test_slab_1d_scrambled_roundtrip(pool):
    n = 1 << 12
    x = crand(rng(23), n)
    res = chain(pool, [("make_plan_slab_1d", (n,), dict(scrambled_out=True)),
                       ("make_plan_slab_1d", (n,),
                        dict(direction=B, scrambled_in=True,
                             norm=Norm.BACKWARD))], x)
    jf = jdist.make_plan_slab_1d(n, mesh=M1(P), scrambled_out=True)
    jb = jdist.make_plan_slab_1d(n, mesh=M1(P), direction=B,
                                 scrambled_in=True, norm=Norm.BACKWARD)
    js = jax_np(jf(x))
    # the scrambled spectrum itself matches the JAX plan's
    assert rel_l2(assemble(res, 0), js) <= tolerance(n)
    agree(assemble(res, 1), jax_np(jb(js)), x, n)


def test_slab_1d_scrambled_in_forward(pool):
    n = 1 << 12
    x = crand(rng(24), n)
    res = chain(pool, [("make_plan_slab_1d", (n,),
                        dict(scrambled_out=True, norm=Norm.NONE)),
                       ("make_plan_slab_1d", (n,),
                        dict(scrambled_in=True, norm=Norm.NONE))], x)
    ja = jdist.make_plan_slab_1d(n, mesh=M1(P), scrambled_out=True,
                                 norm=Norm.NONE)
    jb = jdist.make_plan_slab_1d(n, mesh=M1(P), scrambled_in=True,
                                 norm=Norm.NONE)
    agree(assemble(res, 1), jax_np(jb(ja(x))), np.fft.fft(np.fft.fft(x)), n)


def test_slab_1d_explicit_factors_and_errors(pool):
    n = 1 << 12
    x = crand(rng(25), n)
    j = jdist.make_plan_slab_1d(n, mesh=M1(P), factors=(64, 64))
    y, f = run(pool, "make_plan_slab_1d", x, n, factors=(64, 64))
    assert "4096=64x64" in f["description"]
    agree(y, jax_np(j(x)), np.fft.fft(x), n)
    for args, kw in (((n,), dict(factors=(32, 64))),
                     ((n,), dict(scrambled_in=True, scrambled_out=True)),
                     ((2 * 8 + 1,), {}),
                     ((n,), dict(factors=(2, 2048)))):
        err = pool.run("plan_error", "make_plan_slab_1d", args, kw)
        assert all(e is not None and e[0] == "ValueError" for e in err), err
        with pytest.raises(ValueError):
            jdist.make_plan_slab_1d(*args, mesh=M1(P), **kw)


def test_slab_1d_auto_dispatch(pool):
    n = 1 << 12
    x = crand(rng(26), n)
    j = jdist.make_plan_distributed((n,), n_devices=P)
    y, f = run(pool, "make_plan_distributed", x, (n,))
    assert "plan-distrib-1d" in f["description"]
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fft(x), n)


def _transpose(pool, x, *args):
    """The port's and the JAX plan's transposes of x."""
    name = "make_plan_many_transpose" if len(args) == 3 \
        else "make_plan_transpose"
    y, f = run(pool, name, x, *args)
    j = getattr(R, name)(*args, mesh=M1(P))
    return y, np.asarray(j(x)), f


def test_plan_transpose(pool):
    x = rng(27).standard_normal((16, 24)).astype(np.float32)
    y, jy, f = _transpose(pool, x, 16, 24)
    assert y.dtype == np.float32
    assert np.array_equal(y, x.T) and np.array_equal(y, jy)
    assert f["local_in_shape"] == (4, 24) and f["local_out_shape"] == (6, 16)


def test_plan_transpose_complex(pool):
    x = crand(rng(28), (24, 16))
    y, jy, _ = _transpose(pool, x, 24, 16)
    assert y.dtype == np.complex64
    assert np.array_equal(y, x.T) and np.array_equal(y, jy)


def test_plan_many_transpose(pool):
    x = rng(29).standard_normal((16, 24, 3)).astype(np.float32)
    y, jy, _ = _transpose(pool, x, 16, 24, 3)
    assert np.array_equal(y, np.swapaxes(x, 0, 1)) and np.array_equal(y, jy)


def test_plan_transpose_errors_and_lifecycle(pool):
    err = pool.run("plan_error", "make_plan_transpose", (9, 24), {})
    assert all(e[0] == "ValueError" for e in err)
    with pytest.raises(ValueError):
        R.make_plan_transpose(9, 24, mesh=M1(P))
    err = pool.run("call_error", "make_plan_transpose", (8, 8), {},
                   np.zeros((2, 16), np.float32))
    assert all(e[0] == "ValueError" for e in err)
    err = pool.run("destroyed_call", "make_plan_transpose", (8, 8), {},
                   np.zeros((8, 8), np.float32))
    assert all(e[0] == "RuntimeError" for e in err)


def test_transpose_composes_pipeline(pool):
    x = rng(30).standard_normal((16, 32)).astype(np.float32)
    t1, _ = run(pool, "make_plan_transpose", x, 16, 32)
    y, _ = run(pool, "make_plan_transpose", t1 * 2.0, 32, 16)
    assert np.allclose(y, 2.0 * x)


def test_slab_howmany(pool):
    x = crand(rng(31), (3, 16, 8, 16))
    j = jdist.make_plan_slab((16, 8, 16), mesh=M1(P), howmany=3)
    y, f = run(pool, "make_plan_slab", x, (16, 8, 16), howmany=3)
    assert f["global_shape"] == (3, 16, 8, 16) == j.global_shape
    agree(y, jax_np(j(x)), np.fft.fftn(x, axes=(1, 2, 3)), x.size)


def test_slab_howmany_2d(pool):
    x = crand(rng(32), (4, 16, 24))
    j = jdist.make_plan_slab((16, 24), mesh=M1(P), howmany=4)
    y, _ = run(pool, "make_plan_slab", x, (16, 24), howmany=4)
    agree(y, jax_np(j(x)), np.fft.fftn(x, axes=(1, 2)), x.size)


def test_slab_howmany_chunks_transposed(pool):
    x = crand(rng(33), (3, 16, 8, 16))
    kw = dict(howmany=3, pipeline_chunks=2, transposed_out=True)
    j = jdist.make_plan_slab((16, 8, 16), mesh=M1(P), **kw)
    y, _ = run(pool, "make_plan_slab", x, (16, 8, 16), **kw)
    agree(y, jax_np(j(x)), np.fft.fftn(x, axes=(1, 2, 3)), x.size)


def test_slab_howmany_transposed_in_roundtrip(pool):
    x = crand(rng(34), (3, 16, 8, 16))
    f = dict(howmany=3, transposed_out=True)
    b = dict(howmany=3, transposed_in=True, direction=B, norm=Norm.BACKWARD)
    res = chain(pool, [("make_plan_slab", ((16, 8, 16),), f),
                       ("make_plan_slab", ((16, 8, 16),), b)], x)
    jy = jdist.make_plan_slab((16, 8, 16), mesh=M1(P), **f)(x)
    jb = jdist.make_plan_slab((16, 8, 16), mesh=M1(P), **b)(jy)
    agree(assemble(res, 1), jax_np(jb), x, x.size)


def test_pencil_howmany(pool):
    x = crand(rng(35), (2, 8, 16, 8))
    j = jdist.make_plan_pencil((8, 16, 8), howmany=2, mesh=pencil_mesh((2, 2)))
    y, _ = run(pool, "make_plan_pencil", x, (8, 16, 8), howmany=2,
               mesh_shape=(2, 2))
    agree(y, jax_np(j(x)), np.fft.fftn(x, axes=(1, 2, 3)), x.size)


def test_pencil_howmany_chunks_transposed(pool):
    x = crand(rng(36), (2, 8, 16, 8))
    kw = dict(howmany=2, pipeline_chunks=2, pipeline_chunks2=2,
              transposed_out=True)
    j = jdist.make_plan_pencil((8, 16, 8), mesh=pencil_mesh((2, 2)), **kw)
    y, f = run(pool, "make_plan_pencil", x, (8, 16, 8), mesh_shape=(2, 2),
               **kw)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x, axes=(1, 2, 3)), x.size)


# --- tests/test_distributed_real.py: the per-shard real plans ------------
def test_shards_r2c_matches_per_slab_rfftn(pool):
    shape = (16, 6, 10)
    x = rng(37).standard_normal(shape).astype(np.float32)
    j = jdist.make_plan_shards(shape, kind=Kind.R2C, norm=Norm.NONE,
                               mesh=M1(P))
    y, _ = run(pool, "make_plan_shards", x, shape, kind=Kind.R2C,
               norm=Norm.NONE)
    loc = shape[0] // P
    ref = np.concatenate([np.fft.rfftn(x[i * loc:(i + 1) * loc]
                                       .astype(np.float64))
                          for i in range(P)])
    agree(y, jax_np(j(x)), ref, loc * 60)


def test_shards_r2c_c2r_roundtrip(pool):
    shape = (8, 4, 12)
    x = rng(38).standard_normal(shape).astype(np.float32)
    res = chain(pool, [("make_plan_shards", (shape,),
                        dict(kind=Kind.R2C, norm=Norm.NONE)),
                       ("make_plan_shards", (shape,),
                        dict(kind=Kind.C2R, norm=Norm.BACKWARD))], x)
    jf = jdist.make_plan_shards(shape, kind=Kind.R2C, norm=Norm.NONE,
                                mesh=M1(P))
    jb = jdist.make_plan_shards(shape, kind=Kind.C2R, norm=Norm.BACKWARD,
                                mesh=M1(P))
    back = assemble(res, 1)
    assert back.dtype == np.float32
    agree(back, np.asarray(jb(jf(x))), x, x.size)


def test_shards_1d_r2c_stacked_half_spectra(pool):
    n = 64
    x = rng(39).standard_normal((n,)).astype(np.float32)
    j = jdist.make_plan_shards((n,), kind=Kind.R2C, norm=Norm.NONE,
                               mesh=M1(P))
    y, _ = run(pool, "make_plan_shards", x, (n,), kind=Kind.R2C,
               norm=Norm.NONE)
    loc = n // P
    h = loc // 2 + 1
    assert y.shape == (P * h,)
    ref = np.concatenate([np.fft.rfft(x[i * loc:(i + 1) * loc]
                                      .astype(np.float64)) for i in range(P)])
    agree(y, jax_np(j(x)), ref, n)


def test_interface_make_plan_distrib_real(pool):
    shape = (16, 12)
    x = rng(40).standard_normal(shape).astype(np.float32)
    jp = R.generate_fft_interface(2, np.float32, np.complex64
                                  ).make_plan_distrib(shape, mesh=M1(P))
    y, _ = run(pool, "interface", x, (2, np.float32, np.complex64), shape)
    loc = shape[0] // P
    ref = np.concatenate([np.fft.rfftn(x[i * loc:(i + 1) * loc]
                                       .astype(np.float64))
                          for i in range(P)])
    agree(y, jax_np(jp(x)), ref, x.size)
    # C2R through the interface: the real output of a complex-in plan
    h = y.astype(np.complex64)
    jc = jdist.make_plan_shards(shape, kind=Kind.C2R, norm=Norm.BACKWARD,
                                mesh=M1(P))
    back, _ = run(pool, "make_plan_shards", h, shape, kind=Kind.C2R,
                  norm=Norm.BACKWARD)
    agree(back, np.asarray(jc(h)), x, x.size)


# --- port-only --------------------------------------------------------------
PAIRS = [(2, 0), (0, 2), (2, 1), (1, 0), (0, 1), (1, 2), (3, 1), (1, 3),
         (3, 2), (2, 3)]


def _a2a_expect(blocks, split, concat, order):
    """lax.all_to_all(split_axis=split, concat_axis=concat, tiled=True)
    over mesh positions ``order``: position k's result is the
    concatenation along ``concat`` of every position's k-th chunk along
    ``split``."""
    p = len(order)
    out = {}
    for k in range(p):
        parts = [np.split(blocks[order[q]], p, axis=split)[k]
                 for q in range(p)]
        out[order[k]] = np.concatenate(parts, axis=concat)
    return out


@pytest.mark.parametrize("split,concat", PAIRS)
def test_a2a_block_order(pool, split, concat):
    """The exchange lays the received chunks in rank order along
    ``concat`` for every (split, concat) pair the plans use; a wrong
    order passes at world size 1, the only size the card runs."""
    shape = (4, 8, 12, 4)[:max(split, concat) + 1] + (3,)
    out = pool.run("exchange", shape, split, concat)
    blocks = {r: o["x"] for r, o in enumerate(out)}
    want = _a2a_expect(blocks, split, concat, list(range(P)))
    for r, o in enumerate(out):
        assert o["perm"] is None
        np.testing.assert_array_equal(o["y"], want[r])
        np.testing.assert_array_equal(o["yi"], -want[r])


@pytest.mark.parametrize("split,concat", [(1, 0), (0, 2)])
def test_a2a_block_order_on_a_permuted_mesh(pool, split, concat):
    """Mesh order 3, 2, 1, 0: the group's rank order is not the mesh's,
    and chunk k still goes to (and comes from) mesh position k."""
    shape = (4, 8, 12)
    out = pool.run("exchange", shape, split, concat, mesh=[3, 2, 1, 0],
                   axis=("rev",))
    order = out[0]["line"]
    assert order == [3, 2, 1, 0] and out[0]["perm"] is not None
    blocks = {r: o["x"] for r, o in enumerate(out)}
    want = _a2a_expect(blocks, split, concat, order)
    for r, o in enumerate(out):
        assert o["coord"] == order.index(r)
        np.testing.assert_array_equal(o["y"], want[r])


def _jax_race(monkeypatch, shape, times, chunk_candidates):
    """The JAX package's race on P devices with each strategy timed at
    the maximum over ranks."""
    from regent_fft_tpu.utils import measure as jmeasure
    from regent_fft_tpu.utils import timing as jtiming
    built = []
    real_build = jdist.build_strategy

    def build(strat, *a, **k):
        built.append(jdist.strategy_name(strat))
        return real_build(strat, *a, **k)
    monkeypatch.setattr(jdist, "build_strategy", build)
    monkeypatch.setattr(jtiming, "time_chain",
                        lambda *a, **k: max(times[built[-1]]))
    saved = dict(jdist._DISTRIB_WISDOM)
    jdist._DISTRIB_WISDOM.clear()
    try:
        return jmeasure.measure_distributed(
            shape, norm=Norm.NONE, n_devices=P,
            chunk_candidates=chunk_candidates)
    finally:
        jdist._DISTRIB_WISDOM.clear()
        jdist._DISTRIB_WISDOM.update(saved)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measure_distributed_agrees_across_ranks(pool, monkeypatch, seed):
    """Each rank's time of each strategy differs; every rank takes the
    maximum over ranks (all_reduce MAX), so all return one winner, the
    JAX package's under those maxima; make_plan_distributed then builds
    it from wisdom."""
    shape = (8, 8, 16)
    cands = jdist.candidate_strategies(shape, P, (1, 2))
    names = [jdist.strategy_name(c) for c in cands]
    assert names == [pdist.strategy_name(c) for c in
                     pdist.candidate_strategies(shape, P, (1, 2))]
    g = np.random.default_rng(100 + seed)
    times = {n: [float(v) for v in g.uniform(1.0, 2.0, P)] for n in names}
    # the fastest single rank time is not the fastest maximum
    fast = min(names, key=lambda n: min(times[n]))
    times[fast][int(np.argmax(times[fast]))] = 5.0
    out = pool.run("race", shape, times, (1, 2))
    jw, jt = _jax_race(monkeypatch, shape, times, (1, 2))
    for o in out:
        assert o["winner"] == out[0]["winner"]
        assert o["strategy"] == o["winner"]
        assert o["timings"] == {n: max(times[n]) for n in names}
    w = out[0]["winner"]
    assert pdist.strategy_name(w) == jdist.strategy_name(jw)
    assert jt == out[0]["timings"]
    assert out[0]["distrib"] == [{"shape": list(shape), "n_devices": P,
                                  "direction": -1, "norm": "none",
                                  "kind": "c2c",
                                  "strategy": json.loads(json.dumps(w))}]


def test_measure_mode_plan_on_the_host_timer(pool):
    shape = (8, 8, 16)
    x = crand(rng(41), shape)
    out = pool.run("measured_plan", shape, x)
    # every rank took the slowest rank's host-clock times, so one winner
    assert all(o["strategy"] == out[0]["strategy"] for o in out)
    assert all(o["measurements"] == out[0]["measurements"] for o in out)
    assert out[0]["measurements"]["winner"] == out[0]["strategy"]
    assert set(out[0]["measurements"]["timings"]) == {
        jdist.strategy_name(c)
        for c in jdist.candidate_strategies(shape, P, (1, 2))}
    got = np.zeros(shape, np.complex64)
    for o in out:
        got[o["out_block"]] = o["y"]
    assert rel_l2(got, np.fft.fftn(x)) <= tolerance(x.size)


def test_distrib_wisdom_round_trip():
    """The "distrib" table travels under the JAX package's keys."""
    strat = {"mode": "pencil", "mesh_shape": (2, 4), "pipeline_chunks": 2}
    jkey = jdist._distrib_key((8, 8, 16), 8, Direction.FORWARD, Norm.NONE)
    pkey = pdist._distrib_key((8, 8, 16), 8, rt.Direction.FORWARD,
                              rt.Norm.NONE)
    assert jkey == pkey
    saved = dict(jdist._DISTRIB_WISDOM)
    try:
        rt.forget_wisdom()
        jdist._DISTRIB_WISDOM.clear()
        jdist._DISTRIB_WISDOM[jkey] = dict(strat)
        pdist._DISTRIB_WISDOM[pkey] = dict(strat)
        ours = json.loads(rt.export_wisdom_to_string())["distrib"]
        theirs = json.loads(R.export_wisdom_to_string())["distrib"]
        assert ours == theirs and len(ours) == 1
        s = rt.export_wisdom_to_string()
        rt.forget_wisdom()
        assert pdist._DISTRIB_WISDOM == {}
        assert rt.import_wisdom_from_string(s, build=False) >= 1
        assert pdist._DISTRIB_WISDOM == {pkey: strat}
        assert isinstance(pdist._DISTRIB_WISDOM[pkey]["mesh_shape"], tuple)
    finally:
        rt.forget_wisdom()
        jdist._DISTRIB_WISDOM.clear()
        jdist._DISTRIB_WISDOM.update(saved)


def test_gather_and_broadcast_wisdom(pool):
    entries = [[((8, 8, 8 + r), {"mode": "slab", "pipeline_chunks": 1})]
               for r in range(P)]
    # ranks 1 and 3 disagree on one shape: the later rank wins at rank 0
    entries[1].append(((4, 4, 4), {"mode": "slab", "pipeline_chunks": 2}))
    entries[3].append(((4, 4, 4), {"mode": "slab", "pipeline_chunks": 4}))
    out = pool.run("wisdom_sync", entries)
    assert out[0]["gather"] == 5 and all(o["gather"] == 0 for o in out[1:])
    table = out[0]["after_gather"]
    assert len(table) == P + 1
    assert table[((4, 4, 4), P, -1, "backward", "c2c")] == \
        {"mode": "slab", "pipeline_chunks": 4}
    assert out[0]["broadcast"] == 0
    for o in out[1:]:
        assert o["broadcast"] == P + 1
        assert o["after_broadcast"] == table
    # a one-rank (no) world moves nothing
    assert rt.gather_wisdom() == 0 and rt.broadcast_wisdom() == 0


def test_cuda_plan_on_gloo_group_raises(pool):
    for name, args in (("make_plan_slab", ((8, 8, 8),)),
                       ("make_plan_shards", ((8, 8, 8),)),
                       ("make_plan_pencil", ((8, 8, 8),)),
                       ("make_plan_slab_1d", (4096,)),
                       ("make_plan_transpose", (8, 8)),
                       ("make_plan_slab_r2c", ((8, 8, 8),)),
                       ("make_plan_slab_c2r", ((8, 8, 8),)),
                       ("make_plan_pencil_r2c", ((8, 8, 8),)),
                       ("make_plan_pencil_c2r", ((8, 8, 8),)),
                       ("make_plan_slab_r2r", ((8, 8, 8), 5))):
        err = pool.run("plan_error", name, args, dict(device="cuda"))
        assert all(e[0] == "RuntimeError" and "NCCL" in e[1] for e in err), \
            (name, err)


def test_world_facts(pool):
    out = pool.run("world_facts")
    for o in out:
        assert o["num_nodes"] == o["iface_nodes"] == P
        assert o["num_local_devices"] == o["iface_local"]
        assert o["model"].startswith("rank ") and "backend gloo" in o["model"]


def test_parallel_loads_on_first_use():
    """Importing the package imports no distributed module and needs no
    process group; the names load on first use."""
    import subprocess
    import sys
    probe = ("import sys, regent_fft_tpu_torch as rt\n"
             "assert not any(m.startswith('regent_fft_tpu_torch.parallel')"
             " for m in sys.modules)\n"
             "import torch.distributed as dist\n"
             "assert not dist.is_initialized()\n"
             "assert rt.make_plan_slab.__module__ =="
             " 'regent_fft_tpu_torch.parallel.distributed'\n"
             "assert rt.parallel.mesh.make_fft_mesh is rt.make_fft_mesh\n"
             "assert not dist.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# the layout test: every plan kind's blocks against the JAX shardings
LAYOUTS = [
    ("shards", (8, 4, 6), {}),
    ("shards_r2c", (8, 4, 6), dict(kind=Kind.R2C)),
    ("shards_r2c_1d", (64,), dict(kind=Kind.R2C)),
    ("shards_c2r", (8, 4, 6), dict(kind=Kind.C2R)),
    ("slab", (16, 8, 16), {}),
    ("slab_uneven", (9, 5, 7), {}),
    ("slab_t_out", (10, 4, 6), dict(transposed_out=True)),
    ("slab_t_in", (10, 4, 6), dict(transposed_in=True)),
    ("slab_howmany", (9, 4, 6), dict(howmany=2, transposed_out=True)),
    ("pencil", (8, 8, 16), dict(mesh_shape=(2, 2))),
    ("pencil_uneven", (5, 7, 9), dict(mesh_shape=(2, 2))),
    ("pencil_t_out", (5, 7, 9), dict(mesh_shape=(2, 2), transposed_out=True)),
    ("pencil_4x1", (6, 5, 7), dict(mesh_shape=(4, 1), transposed_out=True)),
    ("slab1d", (4096,), {}),
    ("slab1d_scrambled", (4096,), dict(scrambled_out=True)),
]


def _jax_plan(label, shape, kw):
    kw = dict(kw)
    if label.startswith("shards"):
        return jdist.make_plan_shards(shape, mesh=M1(P), **kw)
    if label.startswith("slab1d"):
        return jdist.make_plan_slab_1d(shape[0], mesh=M1(P), **kw)
    if label.startswith("slab"):
        return jdist.make_plan_slab(shape, mesh=M1(P), **kw)
    return jdist.make_plan_pencil(shape, mesh=pencil_mesh(kw.pop(
        "mesh_shape")), **kw)


@pytest.mark.parametrize("label,shape,kw", LAYOUTS,
                         ids=[lab for lab, _, _ in LAYOUTS])
def test_blocks_are_the_jax_shardings(pool, label, shape, kw):
    """Every rank's in_block/out_block equals the JAX plan's sharding of
    its padded global shape, cut to the true extent."""
    name = ("make_plan_shards" if label.startswith("shards") else
            "make_plan_slab_1d" if label.startswith("slab1d") else
            "make_plan_slab" if label.startswith("slab") else
            "make_plan_pencil")
    args = (shape[0],) if name == "make_plan_slab_1d" else (shape,)
    j = _jax_plan(label, shape, kw)
    kind = kw.get("kind", Kind.C2C)
    howmany = kw.get("howmany", 1)
    bshape = ((howmany,) if howmany > 1 else ()) + tuple(shape)
    if kind == Kind.R2C:
        x = rng(42).standard_normal(bshape).astype(np.float32)
    elif kind == Kind.C2R:
        x = crand(rng(42), shape[:-1] + (shape[-1] // 2 + 1,))
    else:
        x = crand(rng(42), bshape)
    res = chain(pool, [(name, args, kw)], x)
    f = res[0][0]
    off = 1 if howmany > 1 else 0
    jin_shape = x.shape
    jout_shape = f["out_shape"]
    assert port_blocks(f["in_blocks"]) == jax_blocks(j, j.in_sharding,
                                                     jin_shape, off)
    assert port_blocks(f["out_blocks"]) == jax_blocks(j, j.out_sharding,
                                                      jout_shape, off)
    for r, o in enumerate(res):
        assert tuple(b.stop - b.start for b in o[0]["in_blocks"][r]) == \
            o[0]["local_in_shape"]
        assert o[0]["y"].shape == o[0]["local_out_shape"]
    assert tuple(f["in_spec"]) == tuple(j.in_sharding.spec) + (None,) * (
        len(jin_shape) - len(j.in_sharding.spec))
