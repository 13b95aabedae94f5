"""The port's real global plans (slab and pencil R2C/C2R, packed and
unpacked, even and uneven) on 4 and 8 gloo ranks (1 for the card's
world size), against the JAX
package's on the first P of its 8 virtual CPU devices and numpy in
float64.

Mirrors ``tests/test_distributed_real.py`` but its shards tests (those are
in ``test_torch_port_distributed.py``) and the slab and pencil tests of
``tests/test_distributed_uneven.py``: the slab tests on 4 ranks, the 2 x 4
pencils and the JAX uneven tests' shapes on 8.  Each test makes its input
from a numpy seed, runs the JAX plan on it, sends it to the ranks (each
takes its ``in_block``), assembles the port's output from the
``out_block``s and holds it to the JAX output and to numpy within
``tolerance(n)``; the descriptions equal the JAX ones and the blocks its
shardings.  Port-only: the width of every logged exchange on the packed
route, the buffers the exchanges move, rank-4 slabs, a pencil on a mesh
whose ranks are out of world order, and the reversal over a joint axis.
"""
import numpy as np
import pytest
from jax.sharding import Mesh

import jax

from regent_fft_tpu.dtypes import Kind, Norm
from regent_fft_tpu.parallel import distributed as jdist
from regent_fft_tpu.parallel.mesh import make_multislice_mesh
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance
from torch_dist_ref import (agree, assemble, chain, crand, fft_mesh, jax_np,
                            jax_blocks, pencil_mesh, pool_fixture,
                            port_blocks, run)

pool4 = pool_fixture(4)
pool8 = pool_fixture(8)


def rng(seed):
    return np.random.default_rng(seed)


def real(seed, shape):
    return rng(seed).standard_normal(shape).astype(np.float32)


def half(shape):
    return tuple(shape[:-1]) + (shape[-1] // 2 + 1,)


def rfft_ref(x):
    return np.fft.rfftn(np.asarray(x, np.float64))


def _slab(name, shape, p, **kw):
    return getattr(jdist, name)(shape, mesh=fft_mesh(p), **kw)


def _pencil(name, shape, mesh_shape, **kw):
    return getattr(jdist, name)(shape, mesh=pencil_mesh(mesh_shape), **kw)


def slab_r2c(pool, p, x, shape, **kw):
    """The port's slab R2C on the pool against the JAX plan and numpy:
    the port's output and fields, the JAX plan."""
    j = _slab("make_plan_slab_r2c", shape, p, **kw)
    y, f = run(pool, "make_plan_slab_r2c", x, shape, **kw)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), rfft_ref(x), x.size)
    return y, f, j


def irfft_ref(y, shape):
    return np.fft.irfftn(y.astype(np.complex128), s=shape,
                         axes=tuple(range(len(shape))))


FWD_SCALE = {Norm.NONE: lambda n: 1.0, Norm.BACKWARD: lambda n: 1.0,
             Norm.FORWARD: lambda n: 1.0 / n, Norm.ORTHO: lambda n: n ** -0.5}


def roundtrip(pool, ctor, x, shape, fwd_kw, inv_kw, jmesh):
    """R2C then C2R on the pool and in JAX (norms that invert each other):
    the R2C output against the JAX one and numpy, the C2R output against
    the JAX one and x."""
    res = chain(pool, [(f"make_plan_{ctor}_r2c", (shape,), fwd_kw),
                       (f"make_plan_{ctor}_c2r", (shape,), inv_kw)], x)
    jf = getattr(jdist, f"make_plan_{ctor}_r2c")(shape, mesh=jmesh, **fwd_kw)
    jb = getattr(jdist, f"make_plan_{ctor}_c2r")(shape, mesh=jmesh, **inv_kw)
    jy = jf(x)
    agree(assemble(res, 0), jax_np(jy),
          rfft_ref(x) * FWD_SCALE[fwd_kw["norm"]](x.size), x.size)
    back = assemble(res, 1)
    assert back.dtype == np.float32 and back.shape == shape
    agree(back, np.asarray(jb(jy)), x, x.size)
    assert res[0][1]["description"] == jb.description
    return res


# --- tests/test_distributed_real.py, slab (P = 4) --------------------------
def test_slab_r2c_matches_numpy(pool4):
    shape = (16, 8, 12)
    y, f, j = slab_r2c(pool4, 4, real(1, shape), shape, norm=Norm.NONE)
    assert y.shape == half(shape) and y.dtype == np.complex64
    assert "nyquist" not in f["description"]


def test_slab_r2c_transposed_out(pool4):
    shape = (8, 8, 16)
    _, f, j = slab_r2c(pool4, 4, real(2, shape), shape, norm=Norm.NONE,
                       transposed_out=True)
    assert f["out_spec"][1] == "fft" == j.out_sharding.spec[1]


def test_slab_r2c_c2r_roundtrip(pool4):
    shape = (16, 8, 12)
    roundtrip(pool4, "slab", real(3, shape), shape,
              dict(norm=Norm.NONE), dict(norm=Norm.BACKWARD), fft_mesh(4))


def test_slab_r2c_c2r_transposed_pair(pool4):
    shape = (8, 8, 8)
    roundtrip(pool4, "slab", real(4, shape), shape,
              dict(norm=Norm.NONE, transposed_out=True),
              dict(norm=Norm.BACKWARD, transposed_in=True), fft_mesh(4))


def test_slab_r2c_odd_last_axis(pool4):
    shape = (8, 8, 9)
    slab_r2c(pool4, 4, real(5, shape), shape, norm=Norm.NONE)


def test_slab_r2c_shape_validation(pool4):
    f = pool4.run("plan_error", "make_plan_slab_r2c", ((9, 8, 8),), {})
    assert f == [None] * 4
    desc = chain(pool4, [("make_plan_slab_r2c", ((9, 8, 8),), {})],
                 real(6, (9, 8, 8)))[0][0]["description"]
    assert "uneven blocks" in desc
    assert desc == _slab("make_plan_slab_r2c", (9, 8, 8), 4).description
    for name in ("make_plan_slab_r2c", "make_plan_slab_c2r"):
        err = pool4.run("plan_error", name, ((8, 16),), {})
        assert all(e[0] == "ValueError" and "rank >= 3" in e[1]
                   for e in err), err
        with pytest.raises(ValueError):
            _slab(name, (8, 16), 4)


def test_slab_r2c_rejects_complex_input(pool4):
    shape = (8, 8, 16)
    x = crand(rng(7), shape)[:2]
    err = pool4.run("call_error", "make_plan_slab_r2c", (shape,), {}, x)
    assert all(e[0] == "TypeError" for e in err), err
    with pytest.raises(TypeError):
        _slab("make_plan_slab_r2c", shape, 4)(crand(rng(7), shape))


def test_slab_r2c_packed_transport_matches_numpy(pool4):
    shape = (16, 8, 256)
    y, f, _ = slab_r2c(pool4, 4, real(8, shape), shape, norm=Norm.NONE)
    assert y.shape == (16, 8, 129)


def test_slab_r2c_packed_transposed_out(pool4):
    shape = (8, 8, 256)
    slab_r2c(pool4, 4, real(9, shape), shape, norm=Norm.NONE,
             transposed_out=True)


@pytest.mark.parametrize("transposed_in", [False, True])
def test_slab_c2r_packed_matches_irfftn_on_random_spectrum(pool4,
                                                           transposed_in):
    """A non-Hermitian spectrum: the tangle's conjugate-even projection,
    the reversal over the split axis included, gives numpy's irfftn."""
    shape = (16, 8, 256)
    y = crand(rng(10), half(shape))
    kw = dict(norm=Norm.NONE, transposed_in=transposed_in)
    j = _slab("make_plan_slab_c2r", shape, 4, **kw)
    got, f = run(pool4, "make_plan_slab_c2r", y, shape, **kw)
    assert "nyquist-packed" in f["description"] == j.description
    ref = irfft_ref(y, shape) * np.prod(shape)
    agree(got, np.asarray(j(y)), ref, got.size)


def test_slab_r2c_c2r_packed_roundtrip(pool4):
    shape = (16, 8, 256)
    roundtrip(pool4, "slab", real(11, shape), shape,
              dict(norm=Norm.NONE), dict(norm=Norm.BACKWARD), fft_mesh(4))


def test_slab_r2c_c2r_packed_transposed_pair(pool4):
    shape = (8, 8, 256)
    roundtrip(pool4, "slab", real(12, shape), shape,
              dict(norm=Norm.NONE, transposed_out=True),
              dict(norm=Norm.BACKWARD, transposed_in=True), fft_mesh(4))


@pytest.mark.parametrize("norm", [Norm.BACKWARD, Norm.FORWARD, Norm.ORTHO])
def test_slab_real_norms(pool4, norm):
    """Port-only: every norm on both routes, R2C and C2R, against the JAX
    plans (the packed route fuses the scale into the row kernels)."""
    for shape in ((8, 4, 256), (8, 4, 12)):
        x = real(13, shape)
        roundtrip(pool4, "slab", x, shape, dict(norm=norm),
                  dict(norm=norm), fft_mesh(4))


@pytest.mark.parametrize("transposed_out", [False, True])
def test_slab_r2c_rank4(pool4, transposed_out):
    """Port-only: a rank-4 slab (two mid axes, reversed locally around the
    split axis) on the packed route, and its C2R back."""
    shape = (8, 4, 6, 256)
    roundtrip(pool4, "slab", real(14, shape), shape,
              dict(norm=Norm.NONE, transposed_out=transposed_out),
              dict(norm=Norm.BACKWARD, transposed_in=transposed_out),
              fft_mesh(4))


def test_packed_transport_collective_width(pool4):
    """Every exchange of the packed route moves n/2 = 128 lanes, never the
    129-wide half spectrum; the reversal's permutations are logged as
    ppermutes of the lane-0 plane."""
    shape = (16, 8, 256)
    x = real(15, shape)
    out = pool4.run("logged_chain",
                    [("make_plan_slab_r2c", (shape,), dict(norm=Norm.NONE)),
                     ("make_plan_slab_c2r", (shape,),
                      dict(norm=Norm.BACKWARD))], x)
    for o in out:
        recs = o["records"]
        a2a = [m for m in recs if "all_to_all" in m]
        perm = [m for m in recs if "ppermute" in m]
        assert len(a2a) == 4, recs
        assert all(m.endswith("128)") for m in a2a), a2a
        assert not any("129" in m for m in a2a), a2a
        # two reversals (re, im) in R2C, four (bin 0 and Nyquist) in C2R,
        # two permutations each, all of the lane-0 plane (4, 8)
        assert len(perm) == 12 and all("(4, 8)" in m or "(1, 8)" in m
                                       for m in perm), perm
    back = assemble([o["results"] for o in out], 1)
    assert rel_l2(back, x) <= tolerance(x.size)


def test_exchange_buffers(pool4):
    """Port-only: the packed R2C's two exchanges each move both planes at
    n/2 wide in one f32 buffer; the reversal moves the lane-0 plane."""
    shape = (16, 8, 256)
    out = pool4.run("a2a_buffers", [("make_plan_slab_r2c", (shape,),
                                     dict(norm=Norm.NONE))],
                    real(16, shape))
    for o in out:
        bufs = o["buffers"]
        assert bufs[:2] == [("torch.float32", [4, 2, 4, 2, 128])] * 2, bufs
        assert [b[1] for b in bufs[2:]] == [[32], [8], [32], [8]], bufs


# the blocks of every real plan against the JAX plan's shardings
BLOCKS = [
    ("slab_r2c", (16, 8, 256), {}),
    ("slab_r2c", (9, 6, 10), {}),
    ("slab_r2c", (9, 6, 10), dict(transposed_out=True)),
    ("slab_c2r", (16, 8, 256), dict(transposed_in=True)),
    ("slab_c2r", (10, 7, 12), {}),
    ("slab_c2r", (10, 7, 12), dict(transposed_in=True)),
]


def _blocks_check(pool, ctor, shape, kw, jplan):
    x = (real(17, shape) if ctor.endswith("r2c")
         else crand(rng(17), half(shape)))
    res = chain(pool, [(f"make_plan_{ctor}", (shape,), kw)], x)
    f = res[0][0]
    assert f["description"] == jplan.description
    out_shape = half(shape) if ctor.endswith("r2c") else shape
    assert port_blocks(f["in_blocks"]) == jax_blocks(jplan,
                                                     jplan.in_sharding,
                                                     x.shape)
    assert port_blocks(f["out_blocks"]) == jax_blocks(jplan,
                                                      jplan.out_sharding,
                                                      out_shape)
    assert tuple(f["in_spec"]) == tuple(jplan.in_sharding.spec) + (None,) * (
        len(shape) - len(jplan.in_sharding.spec))
    assert tuple(f["out_spec"]) == tuple(jplan.out_sharding.spec) + (
        None,) * (len(shape) - len(jplan.out_sharding.spec))
    for r, o in enumerate(res):
        assert tuple(b.stop - b.start for b in o[0]["in_blocks"][r]) == \
            o[0]["local_in_shape"]
        assert o[0]["y"].shape == o[0]["local_out_shape"]
    ref = (rfft_ref(x) if ctor.endswith("r2c") else
           irfft_ref(x, shape) * np.prod(shape))
    y = assemble(res)
    agree(y, (jax_np if ctor.endswith("r2c") else np.asarray)(jplan(x)),
          ref, int(np.prod(shape)))


@pytest.mark.parametrize("ctor,shape,kw", BLOCKS,
                         ids=[f"{c}-{'x'.join(map(str, s))}-{len(k)}"
                              for c, s, k in BLOCKS])
def test_slab_blocks_are_the_jax_shardings(pool4, ctor, shape, kw):
    kw = dict(kw, norm=Norm.NONE)
    _blocks_check(pool4, ctor, shape, kw,
                  _slab(f"make_plan_{ctor}", shape, 4, **kw))


# --- tests/test_distributed_real.py, pencil (P = 8, a 2 x 4 mesh) ----------
def pencil_r2c(pool, x, shape, mesh_shape=(2, 4), **kw):
    j = _pencil("make_plan_pencil_r2c", shape, mesh_shape, **kw)
    y, f = run(pool, "make_plan_pencil_r2c", x, shape, mesh_shape=mesh_shape,
               **kw)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), rfft_ref(x), x.size)
    return y, f, j


def test_pencil_r2c_matches_numpy(pool8):
    shape = (16, 16, 12)
    _, f, j = pencil_r2c(pool8, real(20, shape), shape, norm=Norm.NONE)
    assert f["out_spec"][0] == ("fy", "fz") == j.out_sharding.spec[0]


def test_pencil_r2c_c2r_roundtrip(pool8):
    shape = (8, 8, 10)
    roundtrip(pool8, "pencil", real(21, shape), shape,
              dict(norm=Norm.NONE, mesh_shape=(2, 4)),
              dict(norm=Norm.BACKWARD, mesh_shape=(2, 4)), None)


def test_pencil_r2c_uneven_blocks(pool8):
    shape = (12, 16, 8)
    _, f, _ = pencil_r2c(pool8, real(22, shape), shape, norm=Norm.NONE)
    assert "uneven" in f["description"]


def test_pencil_r2c_packed_matches_numpy(pool8):
    shape = (16, 16, 256)
    _, f, _ = pencil_r2c(pool8, real(23, shape), shape, norm=Norm.NONE)
    assert "nyquist-packed" in f["description"]


def test_pencil_r2c_c2r_packed_roundtrip(pool8):
    shape = (16, 16, 256)
    res = roundtrip(pool8, "pencil", real(24, shape), shape,
                    dict(norm=Norm.NONE, mesh_shape=(2, 4)),
                    dict(norm=Norm.BACKWARD, mesh_shape=(2, 4)), None)
    assert "nyquist-packed" in res[0][1]["description"]


def test_pencil_c2r_packed_matches_irfftn_on_random_spectrum(pool8):
    shape = (16, 16, 256)
    y = crand(rng(25), half(shape))
    j = _pencil("make_plan_pencil_c2r", shape, (2, 4), norm=Norm.BACKWARD)
    got, f = run(pool8, "make_plan_pencil_c2r", y, shape, mesh_shape=(2, 4),
                 norm=Norm.BACKWARD)
    assert f["description"] == j.description
    agree(got, np.asarray(j(y)),
          irfft_ref(y, shape), got.size)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8), (8, 1)])
def test_pencil_r2c_c2r_other_meshes(pool8, mesh_shape):
    """Port-only: the packed pencil on the other 8-rank meshes."""
    shape = (16, 16, 256)
    pencil_r2c(pool8, real(26, shape), shape, mesh_shape, norm=Norm.NONE)
    x = real(27, shape)
    jm = pencil_mesh(mesh_shape)
    roundtrip(pool8, "pencil", x, shape,
              dict(norm=Norm.NONE, mesh_shape=mesh_shape),
              dict(norm=Norm.BACKWARD, mesh_shape=mesh_shape), jm)


# --- tests/test_distributed_uneven.py:87-113 and :136-148 (P = 8) ---------
def test_slab_r2c_c2r_uneven(pool8):
    shape = (10, 12, 8)
    x = real(30, shape)
    res = roundtrip(pool8, "slab", x, shape, dict(norm=Norm.NONE),
                    dict(norm=Norm.BACKWARD), fft_mesh(8))
    assert "uneven blocks" in res[0][0]["description"]


def test_slab_r2c_c2r_uneven_transposed(pool8):
    shape = (6, 10, 8)
    roundtrip(pool8, "slab", real(31, shape), shape,
              dict(norm=Norm.NONE, transposed_out=True),
              dict(norm=Norm.BACKWARD, transposed_in=True), fft_mesh(8))


def test_pencil_r2c_c2r_uneven(pool8):
    shape = (6, 10, 8)
    res = roundtrip(pool8, "pencil", real(32, shape), shape,
                    dict(norm=Norm.NONE, mesh_shape=(2, 4)),
                    dict(norm=Norm.BACKWARD, mesh_shape=(2, 4)),
                    pencil_mesh((2, 4)))
    assert "uneven blocks" in res[0][1]["description"]


PENCIL_BLOCKS = [
    ("pencil_r2c", (16, 16, 256)),
    ("pencil_r2c", (6, 10, 8)),
    ("pencil_c2r", (16, 16, 256)),
    ("pencil_c2r", (6, 10, 8)),
]


@pytest.mark.parametrize("ctor,shape", PENCIL_BLOCKS,
                         ids=[f"{c}-{'x'.join(map(str, s))}"
                              for c, s in PENCIL_BLOCKS])
def test_pencil_blocks_are_the_jax_shardings(pool8, ctor, shape):
    """Z split jointly over (fy, fz): rank (c1, c2) holds block
    c1 * 4 + c2 of the padded Z, as the JAX plan's P(("fy", "fz"))."""
    kw = dict(norm=Norm.NONE, mesh_shape=(2, 4))
    j = _pencil(f"make_plan_{ctor}", shape, (2, 4), norm=Norm.NONE)
    _blocks_check(pool8, ctor, shape, kw, j)


# --- meshes whose ranks are not in world order ----------------------------
ORDERS = [[[7, 6, 5, 4], [3, 2, 1, 0]], [[1, 3, 5, 7], [0, 2, 4, 6]]]


@pytest.mark.parametrize("ranks", ORDERS, ids=["reversed", "interleaved"])
def test_joint_axis_reversal_out_of_world_order(pool8, ranks):
    """Port-only: the reversal over the joint (a1, a2) axis sends block q
    to position p-1-q and one row on to q+1 in row-major mesh order,
    whatever the ranks' order in the world group."""
    block = 3
    out = pool8.run("joint_reversal", ranks, ("fy", "fz"), block)
    n = 8 * block
    g = np.arange(n, dtype=np.float64)[(-np.arange(n)) % n]
    flat = [r for row in ranks for r in row]
    for rank, o in enumerate(out):
        q = flat.index(rank)
        assert o["coord"] == o["ax_coord"] == q
        assert o["perm"] is not None and o["cols_equal"]
        np.testing.assert_array_equal(o["y"], g[q * block:(q + 1) * block])


@pytest.mark.parametrize("ranks", ORDERS, ids=["reversed", "interleaved"])
def test_pencil_real_on_a_permuted_mesh(pool8, ranks):
    """The packed pencil R2C and C2R on a 2 x 4 mesh of ranks out of world
    order, against the JAX plans on a mesh of those devices: the output,
    the round trip and the joint blocks."""
    shape = (16, 16, 256)
    devs = np.array(jax.devices()[:8], dtype=object)[
        np.array(ranks).reshape(-1)].reshape(2, 4)
    jm = Mesh(devs, ("fy", "fz"))
    mesh = ("ranks", ranks, ("fy", "fz"))
    x = real(33, shape)
    res = chain(pool8, [("make_plan_pencil_r2c", (shape,),
                         dict(norm=Norm.NONE, mesh=mesh)),
                        ("make_plan_pencil_c2r", (shape,),
                         dict(norm=Norm.BACKWARD, mesh=mesh))], x)
    jf = jdist.make_plan_pencil_r2c(shape, mesh=jm, norm=Norm.NONE)
    jb = jdist.make_plan_pencil_c2r(shape, mesh=jm, norm=Norm.BACKWARD)
    jy = jf(x)
    agree(assemble(res, 0), jax_np(jy), rfft_ref(x), x.size)
    agree(assemble(res, 1), np.asarray(jb(jy)), x, x.size)
    # jax_blocks lists mesh positions; the port's lists are in rank order
    f, flat = res[0][0], [r for row in ranks for r in row]
    for got, sharding, gshape in ((f["in_blocks"], jf.in_sharding, shape),
                                  (f["out_blocks"], jf.out_sharding,
                                   half(shape))):
        want = jax_blocks(jf, sharding, gshape)
        assert port_blocks(got) == [want[flat.index(r)] for r in range(8)]


def test_pencil_real_on_the_multislice_mesh(pool8):
    shape = (16, 16, 256)
    x = real(34, shape)
    jm = make_multislice_mesh(2, 4)
    mesh = ("multislice", 2, 4)
    res = chain(pool8, [("make_plan_pencil_r2c", (shape,),
                         dict(norm=Norm.NONE, mesh=mesh)),
                        ("make_plan_pencil_c2r", (shape,),
                         dict(norm=Norm.BACKWARD, mesh=mesh))], x)
    jf = jdist.make_plan_pencil_r2c(shape, mesh=jm, norm=Norm.NONE)
    jb = jdist.make_plan_pencil_c2r(shape, mesh=jm, norm=Norm.BACKWARD)
    jy = jf(x)
    assert res[0][0]["description"] == jf.description
    agree(assemble(res, 0), jax_np(jy), rfft_ref(x), x.size)
    agree(assemble(res, 1), np.asarray(jb(jy)), x, x.size)


def test_real_strategies_build_the_jax_plans(pool8):
    """build_strategy of the real kinds at P = 8 gives the JAX plans:
    the slab and the default 2 x 4 pencil, R2C and C2R."""
    shape = (16, 16, 256)
    x = real(35, shape)
    for strat in jdist.candidate_strategies(shape, 8, kind=Kind.R2C):
        for kind in (Kind.R2C, Kind.C2R):
            j = jdist.build_strategy(strat, shape, norm=Norm.NONE,
                                     n_devices=8, kind=kind)
            inp = x if kind == Kind.R2C else jax_np(
                jdist.make_plan_slab_r2c(shape, norm=Norm.NONE)(x))
            y, f = run(pool8, "build_strategy", inp, strat, shape,
                       norm=Norm.NONE, n_devices=8, kind=kind)
            assert f["description"] == j.description, strat
            ref = (rfft_ref(x) if kind == Kind.R2C
                   else irfft_ref(inp, shape) * x.size)
            agree(y, (jax_np if kind == Kind.R2C else np.asarray)(j(inp)),
                  ref, x.size)


pool1 = pool_fixture(1)


@pytest.mark.parametrize("shape", [(1, 1, 256), (2, 3, 256)])
def test_packed_c2r_leaves_its_input_unwritten(pool1, shape):
    """Port-only: at world size 1 (the card's) a block of one plane and
    one row, (1, 1, 129), is the case where the packed route's first n/2
    lanes of the input are a dense view; the tangle must still write into
    a copy, never into the caller's planes."""
    y = crand(rng(36), half(shape))
    out = pool1.run("c2r_input_kept", shape, y)
    assert all(o["kept"] for o in out), out
    got = np.zeros(shape, np.float32)
    for o in out:
        got[o["out_block"]] = o["y"]
    j = _slab("make_plan_slab_c2r", shape, 1, norm=Norm.NONE)
    assert "nyquist-packed" in j.description
    agree(got, np.asarray(j(y)), irfft_ref(y, shape) * np.prod(shape),
          got.size)
