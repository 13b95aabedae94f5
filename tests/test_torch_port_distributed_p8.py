"""The port's distributed plans (``regent_fft_tpu_torch.parallel``) on 8
gloo ranks where the JAX tests' device count decides the case: the 2 x 4
and 4 x 2 pencils (uneven ones included), the clamped chunk counts, the
2 x 4 multislice pencil, the fuzz over the strategies of 8 devices (C2C,
R2C and C2R) and
``dryrun_multichip(8)``'s C2C checks; against the JAX package's plans on
its 8 virtual CPU devices and numpy in float64 (``tests/test_distributed.py``, ``test_distributed_uneven.py``,
``__graft_entry__.py``)."""
import numpy as np
import pytest

from regent_fft_tpu.dtypes import Direction, Kind, Norm
from regent_fft_tpu.parallel import distributed as jdist
from regent_fft_tpu.parallel.mesh import make_multislice_mesh
from torch_dist_ref import (agree, assemble, chain, crand, fft_mesh, jax_np,
                            jax_blocks, pencil_mesh, pool_fixture,
                            port_blocks, run)

P = 8
pool = pool_fixture(P)
B = Direction.BACKWARD


def rng(seed):
    return np.random.default_rng(seed)


def _pencil(shape, mesh_shape, **kw):
    return jdist.make_plan_pencil(shape, mesh=pencil_mesh(mesh_shape), **kw)


def test_pencil_3d(pool):
    x = crand(rng(1), (8, 8, 16))
    j = _pencil((8, 8, 16), (2, 4))
    y, f = run(pool, "make_plan_pencil", x, (8, 8, 16), mesh_shape=(2, 4))
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_pencil_default_mesh_is_2x4(pool):
    x = crand(rng(2), (8, 8, 16))
    j = jdist.make_plan_pencil((8, 8, 16))
    y, f = run(pool, "make_plan_pencil", x, (8, 8, 16))
    assert "mesh=(2x4)" in f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_pencil_transposed_out(pool):
    x = crand(rng(3), (4, 8, 8))
    j = _pencil((4, 8, 8), (2, 4), transposed_out=True)
    y, f = run(pool, "make_plan_pencil", x, (4, 8, 8), mesh_shape=(2, 4),
               transposed_out=True)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)
    assert port_blocks(f["out_blocks"]) == jax_blocks(j, j.out_sharding,
                                                      (4, 8, 8))


def test_pencil_inverse_roundtrip(pool):
    x = crand(rng(4), (8, 8, 8))
    res = chain(pool, [("make_plan_pencil", ((8, 8, 8),),
                        dict(mesh_shape=(2, 4))),
                       ("make_plan_pencil", ((8, 8, 8),),
                        dict(mesh_shape=(2, 4), direction=B))], x)
    jy = _pencil((8, 8, 8), (2, 4))(x)
    jb = _pencil((8, 8, 8), (2, 4), direction=B)(jy)
    agree(assemble(res, 1), jax_np(jb), x, x.size)


def test_pencil_pipelined_chunks_matches(pool):
    x = crand(rng(5), (8, 8, 16))
    j = _pencil((8, 8, 16), (2, 4), norm=Norm.NONE, pipeline_chunks=2)
    y, _ = run(pool, "make_plan_pencil", x, (8, 8, 16), mesh_shape=(2, 4),
               norm=Norm.NONE, pipeline_chunks=2)
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_pencil_chunks2_matches_unchunked(pool):
    shape = (8, 8, 16)
    x = crand(rng(6), shape)
    base, _ = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 4))
    chunked, _ = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 4),
                     pipeline_chunks2=2)
    np.testing.assert_allclose(chunked, base, rtol=2e-6, atol=2e-6)
    j = _pencil(shape, (2, 4), pipeline_chunks2=2)
    agree(chunked, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_pencil_description_reports_clamped_chunks(pool):
    x = crand(rng(7), (8, 8, 16))
    kw = dict(mesh_shape=(4, 2), pipeline_chunks=8, pipeline_chunks2=16)
    y, f = run(pool, "make_plan_pencil", x, (8, 8, 16), **kw)
    d = f["description"]
    assert "a2a[fz]/2chunks" in d and "a2a[fy]/8chunks" in d, d
    j = jdist.make_plan_pencil((8, 8, 16), **kw)
    assert d == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x), x.size)


def test_multislice_mesh_and_dcn_pencil(pool):
    m = pool.run("multislice", 2, 4)
    assert all(o["names"] == ("slice", "chip") and o["shape"] == (2, 4)
               for o in m)
    shape = (8, 16, 16)
    x = crand(rng(8), shape)
    j = jdist.make_plan_pencil(shape, mesh=make_multislice_mesh(2, 4),
                               transposed_out=True, pipeline_chunks2=2)
    y, f = run(pool, "make_plan_pencil", x, shape,
               mesh=("multislice", 2, 4), transposed_out=True,
               pipeline_chunks2=2)
    assert "a2a[slice]/2chunks" in f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)


@pytest.mark.parametrize("shape", [(6, 10, 9), (5, 7, 12)])
def test_pencil_uneven(pool, shape):
    x = crand(rng(9), shape)
    j = _pencil(shape, (2, 4), norm=Norm.NONE)
    y, f = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 4),
               norm=Norm.NONE)
    assert "uneven blocks" in f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)
    assert port_blocks(f["in_blocks"]) == jax_blocks(j, j.in_sharding, shape)


def test_pencil_uneven_transposed_chunked(pool):
    shape = (6, 10, 9)
    x = crand(rng(10), shape)
    kw = dict(transposed_out=True, pipeline_chunks=2, pipeline_chunks2=2,
              norm=Norm.NONE)
    j = _pencil(shape, (2, 4), **kw)
    y, f = run(pool, "make_plan_pencil", x, shape, mesh_shape=(2, 4), **kw)
    agree(y, jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)), x.size)
    assert port_blocks(f["out_blocks"]) == jax_blocks(j, j.out_sharding,
                                                      shape)


@pytest.mark.parametrize("transposed_out", [False, True])
def test_pencil_y_blocks_follow_the_lcm_padding(pool, transposed_out):
    """Port-only: on a 4 x 2 mesh Y pads to lcm(4, 2) = 4 blocks, so y = 5
    pads to 8 and the input's Y blocks over the 2 columns are 4 and 1,
    not ceil(5/2) = 3 and 2; the blocks are the JAX plan's shardings."""
    shape = (6, 5, 7)
    x = crand(rng(11), shape)
    j = _pencil(shape, (4, 2), norm=Norm.NONE, transposed_out=transposed_out)
    res = chain(pool, [("make_plan_pencil", (shape,),
                        dict(mesh_shape=(4, 2), norm=Norm.NONE,
                             transposed_out=transposed_out))], x)
    f = res[0][0]
    assert port_blocks(f["in_blocks"]) == jax_blocks(j, j.in_sharding, shape)
    assert port_blocks(f["out_blocks"]) == jax_blocks(j, j.out_sharding,
                                                      shape)
    assert {b[1] for b in port_blocks(f["in_blocks"])} == {(0, 4), (4, 5)}
    agree(assemble(res), jax_np(j(x)), np.fft.fftn(x.astype(np.complex128)),
          x.size)


def test_random_distributed_problem_fuzz(pool):
    """The JAX fuzz's draws (seed 777, kinds, shapes and strategies over 8
    devices, its real inputs from the same generator), every one checked:
    the port's plan of the drawn strategy against the JAX plan and numpy,
    with the JAX plan's description."""
    g = np.random.default_rng(777)
    kinds = [Kind.C2C, Kind.R2C, Kind.C2R]
    checked = 0
    for trial in range(8):
        kind = kinds[int(g.integers(len(kinds)))]
        shape = tuple(int(8 * g.integers(1, 4)) for _ in range(3))
        cands = jdist.candidate_strategies(shape, P, (1, 2), kind=kind)
        if not cands:
            continue
        strat = cands[int(g.integers(len(cands)))]
        norm = Norm.BACKWARD if kind == Kind.C2R else Norm.NONE
        if kind == Kind.C2C:
            x = crand(rng(100 + trial), shape)
            ref = np.fft.fftn(x.astype(np.complex128))
        elif kind == Kind.R2C:
            x = g.standard_normal(shape).astype(np.float32)
            ref = np.fft.rfftn(x.astype(np.float64))
        else:
            ref = g.standard_normal(shape).astype(np.float32)
            x = np.fft.rfftn(ref.astype(np.float64)).astype(np.complex64)
        j = jdist.build_strategy(strat, shape, norm=norm, n_devices=P,
                                 kind=kind)
        y, f = run(pool, "build_strategy", x, strat, shape, norm=norm,
                   n_devices=P, kind=kind)
        assert f["description"] == j.description
        jy = np.asarray(j(x)) if kind == Kind.C2R else jax_np(j(x))
        agree(y, jy, ref, int(np.prod(shape)))
        checked += 1
    assert checked >= 5, f"only {checked} feasible problems drawn"


def test_dryrun_multichip_c2c_checks(pool):
    """``__graft_entry__.dryrun_multichip(8)``'s C2C checks: a 2 x 4
    pencil and its inverse, the slab, the shards, the auto-dispatched and
    the multislice pencil, each within 1e-4 of numpy."""
    g = np.random.default_rng(0)
    p1, p2, lcm = 2, 4, 4
    z, y_, x_ = 2 * p1, 2 * lcm, 2 * p2
    xc = crand(g, (z, y_, x_))
    ref = np.fft.fftn(xc.astype(np.complex128))
    res = chain(pool, [("make_plan_pencil", ((z, y_, x_),),
                        dict(mesh_shape=(p1, p2))),
                       ("make_plan_pencil", ((z, y_, x_),),
                        dict(mesh_shape=(p1, p2), direction=B))], xc)
    fwd = _pencil((z, y_, x_), (p1, p2))
    agree(assemble(res, 0), jax_np(fwd(xc)), ref, xc.size)
    assert np.linalg.norm(assemble(res, 1) - xc) / np.linalg.norm(xc) < 1e-4
    s = max(P, 4)
    xs = crand(g, (s, 4, s))
    ref_s = np.fft.fftn(xs.astype(np.complex128))
    j = jdist.make_plan_slab((s, 4, s), mesh=fft_mesh(P))
    y, _ = run(pool, "make_plan_slab", xs, (s, 4, s))
    agree(y, jax_np(j(xs)), ref_s, xs.size)
    xb = crand(g, (P, 4, 8))
    j = jdist.make_plan_shards((P, 4, 8), mesh=fft_mesh(P))
    y, _ = run(pool, "make_plan_shards", xb, (P, 4, 8))
    agree(y, jax_np(j(xb)), np.fft.fftn(xb.astype(np.complex128),
                                        axes=(1, 2)), 32)
    j = jdist.make_plan_distributed((s, 4, s), norm=Norm.NONE, n_devices=P)
    y, f = run(pool, "make_plan_distributed", xs, (s, 4, s), norm=Norm.NONE,
               n_devices=P)
    assert f["description"] == j.description
    agree(y, jax_np(j(xs)), ref_s, xs.size)
    j = jdist.make_plan_pencil((z, y_, x_),
                               mesh=make_multislice_mesh(p1, p2),
                               transposed_out=True, pipeline_chunks2=2)
    y, _ = run(pool, "make_plan_pencil", xc, (z, y_, x_),
               mesh=("multislice", p1, p2), transposed_out=True,
               pipeline_chunks2=2)
    agree(y, jax_np(j(xc)), ref, xc.size)


def test_dryrun_multichip_real_checks(pool):
    """``dryrun_multichip(8)``'s real checks: the slab R2C and its C2R back,
    the rank-1 R2C at n = 16 * 8 * 8 and the 3-D DCT-II over the mesh,
    each within 1e-4 of numpy/scipy and agreeing with the JAX plans."""
    import scipy.fft as sfft
    from regent_fft_tpu.ops.r2r import R2RKind
    from regent_fft_tpu.parallel.distributed_r2r import make_plan_slab_r2r
    g = np.random.default_rng(0)
    rs = (2 * P, 2 * P, 6)
    xr = g.standard_normal(rs).astype(np.float32)
    res = chain(pool, [("make_plan_slab_r2c", (rs,), dict(norm=Norm.NONE)),
                       ("make_plan_slab_c2r", (rs,),
                        dict(norm=Norm.BACKWARD))], xr)
    jr = jdist.make_plan_slab_r2c(rs, mesh=fft_mesh(P), norm=Norm.NONE)
    agree(assemble(res, 0), jax_np(jr(xr)),
          np.fft.rfftn(xr.astype(np.float64)), xr.size)
    back = assemble(res, 1)
    assert np.linalg.norm(back - xr) / np.linalg.norm(xr) < 1e-4
    n1d = 16 * P * P
    x1 = g.standard_normal(n1d).astype(np.float32)
    j1 = jdist.make_plan_slab_1d(n1d, kind=Kind.R2C, mesh=fft_mesh(P),
                                 norm=Norm.NONE)
    y1, f = run(pool, "make_plan_slab_1d", x1, n1d, kind=Kind.R2C,
                norm=Norm.NONE)
    assert f["description"] == j1.description
    agree(jdist.unpack_halfcomplex_rank1(y1),
          jdist.unpack_halfcomplex_rank1(np.asarray(j1(x1))),
          np.fft.rfft(x1.astype(np.float64)), n1d)
    rs2 = (2 * P, 4, 2 * P)
    x2 = g.standard_normal(rs2).astype(np.float32)
    j2 = make_plan_slab_r2r(rs2, R2RKind.REDFT10, mesh=fft_mesh(P))
    y2, f = run(pool, "make_plan_slab_r2r", x2, rs2, int(R2RKind.REDFT10))
    assert f["description"] == j2.description
    agree(y2, np.asarray(j2(x2)), sfft.dctn(x2.astype(np.float64), type=2),
          x2.size)
