"""The port's real rank-1 plans, distributed r2r plans and the real kinds
of the strategy layer on 4 and 5 gloo ranks, against the JAX package's on
the first P of its 8 virtual CPU devices and numpy/scipy in float64.

Mirrors the rank-1 tests of ``tests/test_distributed_real.py`` (:248-311),
the r2r tests of ``tests/test_distributed_extra.py`` (:150-200), the R2C
half of ``tests/test_distributed.py``'s race and dispatch tests and, on 5
ranks (a prime count: short and empty blocks), the uneven real slabs of
``tests/test_distributed_uneven.py``.  Port-only: every r2r kind over the
mesh, the exchanges moving one real plane, the halfcomplex helpers against
the JAX ones, and the real races under rank-dependent injected times
against the JAX race at the per-strategy maxima.
"""
import json

import numpy as np
import pytest
import scipy.fft as sfft

import regent_fft_tpu as R
import regent_fft_tpu_torch as rt
from regent_fft_tpu.dtypes import Direction, Kind, Norm
from regent_fft_tpu.ops.r2r import R2RKind
from regent_fft_tpu.parallel import distributed as jdist
from regent_fft_tpu_torch.parallel import distributed as pdist
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance
from torch_dist_ref import (agree, assemble, chain, crand, fft_mesh, jax_np,
                            jax_blocks, pool_fixture, port_blocks, run)

pool4 = pool_fixture(4)
pool5 = pool_fixture(5)


def rng(seed):
    return np.random.default_rng(seed)


def real(seed, shape):
    return rng(seed).standard_normal(shape).astype(np.float32)


def half(shape):
    return tuple(shape[:-1]) + (shape[-1] // 2 + 1,)


# --- the rank-1 real plans (tests/test_distributed_real.py:248-311) ------
def _r1(n, p, **kw):
    return jdist.make_plan_slab_1d(n, mesh=fft_mesh(p), **kw)


@pytest.mark.parametrize("n", [512, 4096, 2 ** 16, 2 ** 22])
def test_slab_1d_r2c_matches_rfft(pool4, n):
    x = real(1, n)
    j = _r1(n, 4, kind=Kind.R2C, norm=Norm.NONE)
    y, f = run(pool4, "make_plan_slab_1d", x, n, kind=Kind.R2C,
               norm=Norm.NONE)
    assert y.shape == (n // 2,) and f["global_shape"] == (n // 2,)
    assert f["description"] == j.description
    ref = np.fft.rfft(x.astype(np.float64))
    got = rt.unpack_halfcomplex_rank1(y)
    agree(got, jdist.unpack_halfcomplex_rank1(np.asarray(j(x))), ref, n)


def test_slab_1d_r2c_c2r_roundtrip(pool4):
    n = 4096
    x = real(2, n)
    res = chain(pool4, [("make_plan_slab_1d", (n,),
                         dict(kind=Kind.R2C, norm=Norm.NONE)),
                        ("make_plan_slab_1d", (n,),
                         dict(kind=Kind.C2R, norm=Norm.BACKWARD))], x)
    jf = _r1(n, 4, kind=Kind.R2C, norm=Norm.NONE)
    jb = _r1(n, 4, kind=Kind.C2R, norm=Norm.BACKWARD)
    assert res[0][1]["description"] == jb.description
    back = assemble(res, 1)
    assert back.dtype == np.float32
    agree(back, np.asarray(jb(jf(x))), x, n)


def test_slab_1d_c2r_from_numpy_halfspectrum(pool4):
    n = 2048
    x = rng(3).standard_normal(n)
    h = np.fft.rfft(x)
    packed = rt.pack_halfcomplex_rank1(h)
    np.testing.assert_array_equal(packed, jdist.pack_halfcomplex_rank1(h))
    j = _r1(n, 4, kind=Kind.C2R, norm=Norm.BACKWARD)
    back, _ = run(pool4, "make_plan_slab_1d", packed, n, kind=Kind.C2R,
                  norm=Norm.BACKWARD)
    agree(back, np.asarray(j(packed)), x, n)


def test_slab_1d_real_validation(pool4):
    for args, kw in (((4097,), dict(kind=Kind.R2C)),
                     ((4096,), dict(kind=Kind.R2C, scrambled_out=True)),
                     ((4096,), dict(kind=Kind.C2R, scrambled_in=True)),
                     ((4096,), dict(kind=Kind.R2C, factors=(32, 32))),
                     ((4098,), dict(kind=Kind.R2C))):
        err = pool4.run("plan_error", "make_plan_slab_1d", args, kw)
        assert all(e is not None and e[0] == "ValueError" for e in err), \
            (args, kw, err)
        with pytest.raises(ValueError):
            _r1(*args, 4, **kw)
    x = crand(rng(4), 4096)[:1024]
    err = pool4.run("call_error", "make_plan_slab_1d", (4096,),
                    dict(kind=Kind.R2C), x)
    assert all(e[0] == "TypeError" for e in err), err
    with pytest.raises(TypeError):
        _r1(4096, 4, kind=Kind.R2C)(crand(rng(4), 4096))


def test_slab_1d_real_candidates_and_dispatch(pool4):
    for kind in (Kind.R2C, Kind.C2R):
        assert pdist.candidate_strategies(
            (2 ** 14,), 4, kind=pdist.Kind(kind.value)) == \
            jdist.candidate_strategies((2 ** 14,), 4, kind=kind) == \
            [{"mode": "slab1d"}]
    x = real(5, 2 ** 14)
    j = jdist.make_plan_distributed((2 ** 14,), kind=Kind.R2C,
                                    norm=Norm.NONE, n_devices=4)
    y, f = run(pool4, "make_plan_distributed", x, (2 ** 14,), kind=Kind.R2C,
               norm=Norm.NONE)
    assert f["description"] == j.description
    agree(rt.unpack_halfcomplex_rank1(y),
          jdist.unpack_halfcomplex_rank1(np.asarray(j(x))),
          np.fft.rfft(x.astype(np.float64)), 2 ** 14)


def test_slab_1d_real_explicit_factors(pool4):
    n = 4096
    x = real(6, n)
    j = _r1(n, 4, kind=Kind.R2C, norm=Norm.NONE, factors=(32, 64))
    y, f = run(pool4, "make_plan_slab_1d", x, n, kind=Kind.R2C,
               norm=Norm.NONE, factors=(32, 64))
    assert "m=2048=32x64" in f["description"] == j.description
    agree(rt.unpack_halfcomplex_rank1(y),
          jdist.unpack_halfcomplex_rank1(np.asarray(j(x))),
          np.fft.rfft(x.astype(np.float64)), n)


@pytest.mark.parametrize("norm", [Norm.BACKWARD, Norm.FORWARD, Norm.ORTHO])
def test_slab_1d_real_norms(pool4, norm):
    n = 4096
    x = real(7, n)
    res = chain(pool4, [("make_plan_slab_1d", (n,),
                         dict(kind=Kind.R2C, norm=norm)),
                        ("make_plan_slab_1d", (n,),
                         dict(kind=Kind.C2R, norm=norm))], x)
    jf = _r1(n, 4, kind=Kind.R2C, norm=norm)
    jb = _r1(n, 4, kind=Kind.C2R, norm=norm)
    jy = jf(x)
    scale = {Norm.BACKWARD: 1.0, Norm.FORWARD: 1.0 / n,
             Norm.ORTHO: n ** -0.5}[norm]
    agree(rt.unpack_halfcomplex_rank1(assemble(res, 0)),
          jdist.unpack_halfcomplex_rank1(np.asarray(jy)),
          np.fft.rfft(x.astype(np.float64)) * scale, n)
    agree(assemble(res, 1), np.asarray(jb(jy)), x, n)


@pytest.mark.parametrize("m", [1, 2, 7, 64])
def test_halfcomplex_helpers_match_jax(m):
    h = (rng(8).standard_normal(m + 1)
         + 1j * rng(9).standard_normal(m + 1))
    np.testing.assert_array_equal(rt.pack_halfcomplex_rank1(h),
                                  jdist.pack_halfcomplex_rank1(h))
    y = crand(rng(10), m)
    np.testing.assert_array_equal(rt.unpack_halfcomplex_rank1(y),
                                  jdist.unpack_halfcomplex_rank1(y))


# --- distributed r2r (tests/test_distributed_extra.py:150-200) ------------
def _r2r(shape, kinds, p, **kw):
    return R.make_plan_slab_r2r(shape, kinds, mesh=fft_mesh(p), **kw)


def _ival(kinds):
    """Kinds as ints: the ranks never unpickle the JAX package's enum."""
    if isinstance(kinds, (tuple, list)):
        return tuple(int(k) for k in kinds)
    return int(kinds)


def r2r_run(pool, p, x, shape, kinds, **kw):
    j = _r2r(shape, kinds, p, **kw)
    y, f = run(pool, "make_plan_slab_r2r", x, shape, _ival(kinds), **kw)
    assert f["description"] == j.description
    assert y.dtype == np.float32
    return y, np.asarray(j(x)), f, j


def test_slab_r2r_dct2_3d(pool4):
    x = real(11, (16, 12, 24))
    y, jy, _, _ = r2r_run(pool4, 4, x, (16, 12, 24), R2RKind.REDFT10)
    agree(y, jy, sfft.dctn(x.astype(np.float64), type=2), x.size)


def test_slab_r2r_mixed_kinds(pool4):
    x = real(12, (16, 12, 24))
    kinds = (R2RKind.RODFT10, R2RKind.REDFT10, R2RKind.DHT)
    y, jy, _, _ = r2r_run(pool4, 4, x, (16, 12, 24), kinds)
    x64 = x.astype(np.float64)
    ref = sfft.dst(sfft.dct(x64, type=2, axis=1), type=2, axis=0)
    fr = np.fft.fft(ref, axis=2)
    agree(y, jy, fr.real - fr.imag, x.size)


def test_slab_r2r_2d_and_transposed_out(pool4):
    x = real(13, (16, 32))
    y, jy, f, j = r2r_run(pool4, 4, x, (16, 32), R2RKind.REDFT10,
                          transposed_out=True)
    agree(y, jy, sfft.dctn(x.astype(np.float64), type=2), x.size)
    assert f["out_spec"] == (None, "fft") == tuple(j.out_sharding.spec)


def test_slab_r2r_roundtrip(pool4):
    shape = (16, 8, 16)
    x = real(14, shape)
    res = chain(pool4, [("make_plan_slab_r2r", (shape, int(R2RKind.REDFT10)),
                         {}),
                        ("make_plan_slab_r2r", (shape, int(R2RKind.REDFT01)),
                         {})], x)
    scale = float(np.prod([2 * s for s in shape]))
    jb = _r2r(shape, R2RKind.REDFT01, 4)(_r2r(shape, R2RKind.REDFT10, 4)(x))
    agree(assemble(res, 1) / scale, np.asarray(jb) / scale, x, x.size)


def test_slab_r2r_errors(pool4):
    for args in (((16,), int(R2RKind.REDFT10)),
                 ((9, 16), int(R2RKind.REDFT10)),
                 ((16, 18), int(R2RKind.REDFT10)),
                 ((16, 16), (int(R2RKind.REDFT10),) * 3)):
        err = pool4.run("plan_error", "make_plan_slab_r2r", args, {})
        assert all(e is not None and e[0] == "ValueError" for e in err), \
            (args, err)
        with pytest.raises(ValueError):
            R.make_plan_slab_r2r(args[0], args[1], mesh=fft_mesh(4))
    x = crand(rng(15), (16, 16))[:4]
    err = pool4.run("call_error", "make_plan_slab_r2r",
                    ((16, 16), int(R2RKind.REDFT10)), {}, x)
    assert all(e[0] == "TypeError" for e in err), err
    with pytest.raises(TypeError):
        _r2r((16, 16), R2RKind.REDFT10, 4)(crand(rng(15), (16, 16)))


def _r2r_ref_1d(x, kind, axis):
    """FFTW's unnormalized r2r of one kind along ``axis``, in float64."""
    kind = R2RKind(kind)
    dct = {R2RKind.REDFT00: 1, R2RKind.REDFT10: 2, R2RKind.REDFT01: 3,
           R2RKind.REDFT11: 4}
    dst = {R2RKind.RODFT00: 1, R2RKind.RODFT10: 2, R2RKind.RODFT01: 3,
           R2RKind.RODFT11: 4}
    if kind in dct:
        return sfft.dct(x, type=dct[kind], axis=axis)
    if kind in dst:
        return sfft.dst(x, type=dst[kind], axis=axis)
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if kind == R2RKind.DHT:
        f = np.fft.fft(x)
        y = f.real - f.imag
    elif kind == R2RKind.R2HC:
        f = np.fft.rfft(x)
        y = np.concatenate([f.real, f.imag[..., 1:(n + 1) // 2][..., ::-1]],
                           -1)
    else:                                   # HC2R
        h = np.zeros(x.shape[:-1] + (n // 2 + 1,), complex)
        h.real = x[..., :n // 2 + 1]
        h.imag[..., 1:(n + 1) // 2] = x[..., n // 2 + 1:][..., ::-1]
        y = n * np.fft.irfft(h, n)
    return np.moveaxis(y, -1, axis)


@pytest.mark.parametrize("kind", list(R2RKind), ids=[k.name for k in R2RKind])
def test_slab_r2r_every_kind(pool4, kind):
    """Port-only: each FFTW kind on every axis of an 8 x 6 x 12 slab,
    against the JAX plan and FFTW's definition in float64."""
    shape = (8, 6, 12)
    x = real(16, shape)
    y, jy, _, _ = r2r_run(pool4, 4, x, shape, kind)
    ref = x.astype(np.float64)
    for a in range(3):
        ref = _r2r_ref_1d(ref, kind, a)
    agree(y, jy, ref, x.size)


@pytest.mark.parametrize("transposed_out", [False, True])
def test_slab_r2r_blocks_and_one_real_plane(pool4, transposed_out):
    """The blocks are the JAX shardings, and each exchange moves one f32
    plane (half the bytes of a C2C plan of the shape)."""
    shape = (16, 6, 12)
    x = real(17, shape)
    kw = dict(transposed_out=transposed_out)
    j = _r2r(shape, R2RKind.REDFT10, 4, **kw)
    out = pool4.run("a2a_buffers", [("make_plan_slab_r2r",
                                     (shape, int(R2RKind.REDFT10)), kw)], x)
    want = [("torch.float32", [4, 1, 4, 6, 3]),
            ("torch.float32", [4, 1, 4, 6, 3])][:1 if transposed_out else 2]
    for o in out:
        assert o["buffers"] == want, o["buffers"]
    f = out[0]["results"][0]
    assert port_blocks(f["in_blocks"]) == jax_blocks(j, j.in_sharding, shape)
    assert port_blocks(f["out_blocks"]) == jax_blocks(j, j.out_sharding,
                                                      shape)
    agree(assemble([o["results"] for o in out]), np.asarray(j(x)),
          sfft.dctn(x.astype(np.float64), type=2), x.size)


# --- the real strategy layer and race (P = 4) -----------------------------
def _jax_race(monkeypatch, shape, times, kind):
    """The JAX package's race of ``kind`` on 4 devices with each strategy
    timed at the maximum over ranks."""
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
        return jmeasure.measure_distributed(shape, norm=Norm.NONE,
                                            n_devices=4, kind=kind)
    finally:
        jdist._DISTRIB_WISDOM.clear()
        jdist._DISTRIB_WISDOM.update(saved)


@pytest.mark.parametrize("kind,seed", [(Kind.R2C, 0), (Kind.R2C, 1),
                                       (Kind.C2R, 0), (Kind.C2R, 1)])
def test_measure_distributed_real_agrees_across_ranks(pool4, monkeypatch,
                                                      kind, seed):
    """The real races: each rank's time of each candidate differs; every
    rank takes the maximum, so all return one winner, the JAX package's
    under those maxima; the "distrib" wisdom is keyed with the kind and
    make_plan_distributed then builds the winner."""
    shape = (8, 8, 16)
    cands = jdist.candidate_strategies(shape, 4, kind=kind)
    names = [jdist.strategy_name(c) for c in cands]
    assert names == [pdist.strategy_name(c) for c in
                     pdist.candidate_strategies(shape, 4,
                                                kind=pdist.Kind(kind.value))]
    assert names == ["slab/c1", "pencil2x2/c1"]
    g = np.random.default_rng(200 + seed)
    times = {n: [float(v) for v in g.uniform(1.0, 2.0, 4)] for n in names}
    fast = min(names, key=lambda n: min(times[n]))
    times[fast][int(np.argmax(times[fast]))] = 5.0
    out = pool4.run("race", shape, times, (1, 2, 4), kind)
    jw, jt = _jax_race(monkeypatch, shape, times, kind)
    for o in out:
        assert o["winner"] == out[0]["winner"] == o["strategy"]
        assert o["timings"] == {n: max(times[n]) for n in names}
    w = out[0]["winner"]
    assert pdist.strategy_name(w) == jdist.strategy_name(jw)
    assert jt == out[0]["timings"]
    assert out[0]["distrib"] == [{"shape": list(shape), "n_devices": 4,
                                  "direction": -1, "norm": "none",
                                  "kind": kind.value,
                                  "strategy": json.loads(json.dumps(w))}]
    j = jdist.build_strategy(jw, shape, norm=Norm.NONE, n_devices=4,
                             kind=kind)
    assert out[0]["description"] == j.description


def test_measure_mode_real_plan_on_the_host_timer(pool4):
    shape = (8, 8, 16)
    x = real(18, shape)
    out = pool4.run("measured_plan", shape, x, Kind.R2C)
    assert all(o["strategy"] == out[0]["strategy"] for o in out)
    assert all(o["measurements"] == out[0]["measurements"] for o in out)
    assert set(out[0]["measurements"]["timings"]) == {"slab/c1",
                                                      "pencil2x2/c1"}
    got = np.zeros(half(shape), np.complex64)
    for o in out:
        got[o["out_block"]] = o["y"]
    assert rel_l2(got, np.fft.rfftn(x.astype(np.float64))) <= \
        tolerance(x.size)


@pytest.mark.parametrize("shape", [(8, 8, 256), (6, 5, 8), (8, 4, 4, 12)])
@pytest.mark.parametrize("kind", [Kind.R2C, Kind.C2R])
def test_estimate_real_dispatch_is_the_jax_plan(pool4, shape, kind):
    """make_plan_distributed in estimate mode of a real kind: the JAX
    choice by padded volume (slab first at equal padding), its plan."""
    j = jdist.make_plan_distributed(shape, kind=kind, norm=Norm.NONE,
                                    n_devices=4)
    x = (real(19, shape) if kind == Kind.R2C
         else crand(rng(19), half(shape)))
    y, f = run(pool4, "make_plan_distributed", x, shape, kind=kind,
               norm=Norm.NONE)
    assert f["description"] == j.description
    if kind == Kind.R2C:
        ref, jy = np.fft.rfftn(x.astype(np.float64)), jax_np(j(x))
    else:
        ref = np.fft.irfftn(x.astype(np.complex128), s=shape,
                            axes=tuple(range(len(shape)))) * np.prod(shape)
        jy = np.asarray(j(x))
    agree(y, jy, ref, int(np.prod(shape)))


# --- 5 ranks: uneven real slabs (tests/test_distributed_uneven.py:87-113) --
def roundtrip5(pool, x, shape, fwd_kw, inv_kw):
    res = chain(pool, [("make_plan_slab_r2c", (shape,), fwd_kw),
                       ("make_plan_slab_c2r", (shape,), inv_kw)], x)
    jf = jdist.make_plan_slab_r2c(shape, mesh=fft_mesh(5), **fwd_kw)
    jb = jdist.make_plan_slab_c2r(shape, mesh=fft_mesh(5), **inv_kw)
    jy = jf(x)
    assert res[0][0]["description"] == jf.description
    assert res[0][1]["description"] == jb.description
    agree(assemble(res, 0), jax_np(jy), np.fft.rfftn(x.astype(np.float64)),
          x.size)
    agree(assemble(res, 1), np.asarray(jb(jy)), x, x.size)
    return res, jf, jb


@pytest.mark.parametrize("shape", [(10, 12, 8), (7, 10, 256), (9, 6, 9)])
def test_slab_r2c_c2r_uneven_p5(pool5, shape):
    """Uneven blocks take the unpacked route (a last axis of 256 too)."""
    res, jf, _ = roundtrip5(pool5, real(20, shape), shape,
                            dict(norm=Norm.NONE), dict(norm=Norm.BACKWARD))
    assert "uneven blocks" in jf.description
    assert "nyquist" not in res[0][1]["description"]


def test_slab_r2c_c2r_uneven_transposed_p5(pool5):
    shape = (6, 10, 8)
    roundtrip5(pool5, real(21, shape), shape,
               dict(norm=Norm.NONE, transposed_out=True),
               dict(norm=Norm.BACKWARD, transposed_in=True))


@pytest.mark.parametrize("kw", [{}, dict(transposed_out=True)],
                         ids=["natural", "transposed_out"])
def test_slab_r2c_empty_blocks_p5(pool5, kw):
    """3 planes and 4 rows over 5 ranks: the last blocks are empty; the
    blocks are the JAX shardings."""
    shape = (3, 4, 16)
    res, jf, jb = roundtrip5(pool5, real(22, shape), shape,
                             dict(norm=Norm.NONE, **kw),
                             dict(norm=Norm.BACKWARD,
                                  transposed_in=bool(kw)))
    f = res[0][0]
    assert port_blocks(f["in_blocks"]) == jax_blocks(jf, jf.in_sharding,
                                                     shape)
    assert port_blocks(f["out_blocks"]) == jax_blocks(jf, jf.out_sharding,
                                                      half(shape))
    sizes = [np.prod([s.stop - s.start for s in b]) for b in f["out_blocks"]]
    assert 0 in sizes


def test_slab_1d_real_p5(pool5):
    n = 800                                   # m = 400 = 20 x 20
    x = real(23, n)
    res = chain(pool5, [("make_plan_slab_1d", (n,),
                         dict(kind=Kind.R2C, norm=Norm.NONE)),
                        ("make_plan_slab_1d", (n,),
                         dict(kind=Kind.C2R, norm=Norm.BACKWARD))], x)
    jf = jdist.make_plan_slab_1d(n, mesh=fft_mesh(5), kind=Kind.R2C,
                                 norm=Norm.NONE)
    jb = jdist.make_plan_slab_1d(n, mesh=fft_mesh(5), kind=Kind.C2R,
                                 norm=Norm.BACKWARD)
    jy = jf(x)
    assert res[0][0]["description"] == jf.description
    agree(rt.unpack_halfcomplex_rank1(assemble(res, 0)),
          jdist.unpack_halfcomplex_rank1(np.asarray(jy)),
          np.fft.rfft(x.astype(np.float64)), n)
    agree(assemble(res, 1), np.asarray(jb(jy)), x, n)


@pytest.mark.parametrize("transposed_out", [False, True])
def test_slab_r2r_p5(pool5, transposed_out):
    shape = (10, 6, 15)
    x = real(24, shape)
    y, jy, _, _ = r2r_run(pool5, 5, x, shape, R2RKind.REDFT10,
                          transposed_out=transposed_out)
    agree(y, jy, sfft.dctn(x.astype(np.float64), type=2), x.size)


def test_real_dispatch_p5(pool5):
    """At 5 ranks the only real strategy of a 3-D shape is the slab (no
    2-D mesh but 1 x 5)."""
    shape = (10, 12, 8)
    assert pdist.candidate_strategies(shape, 5, kind=pdist.Kind.R2C) == \
        jdist.candidate_strategies(shape, 5, kind=Kind.R2C) == \
        [{"mode": "slab", "pipeline_chunks": 1}]
    x = real(25, shape)
    j = jdist.make_plan_distributed(shape, kind=Kind.R2C, norm=Norm.NONE,
                                    n_devices=5)
    y, f = run(pool5, "make_plan_distributed", x, shape, kind=Kind.R2C,
               norm=Norm.NONE)
    assert f["description"] == j.description
    agree(y, jax_np(j(x)), np.fft.rfftn(x.astype(np.float64)), x.size)
