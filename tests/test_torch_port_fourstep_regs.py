"""The four-step column kernel (csrc/fourstep.cu, ``fft_cols_fs_kernel``:
the C entries ``fft_cols_tw``, ``a0fs_a``, ``a0fs_b`` and their bf16
stages) emulated on the CPU.

The kernel is ``fft_cols``' register column body (csrc/cols.cuh) with a
store policy of its own.  A column of n points is held by TPC = n / E
threads (E values each, from the ``COLS_CASE`` table), a block takes C
neighbouring columns of one plane of the (P, n, V) view: thread t is column
t % C, lane t // C.  Stage 0 reads device memory directly (lane j takes
elements j + r*M, r < R0), every later stage reads the shared buffer the
stage before it wrote (element x of column c at x*C + c, or XOR-swizzled
within 32-word rows when C < 32), and the last stage writes output element
k of column v of plane q to ooff + k*old, ooff = ((q // g)*g*n + q % g)*V
+ v and old = g*V, times the four-step twiddle W_N^{k*(v // tdiv)} formed
from the exact integer phase, or times the scale:

* ``fft_cols_tw``: (b, n1, n2) planes, g = 1, tdiv = 1, N = n1*n2;
* stage a: the (pre, r1, r2*post) view, g = 1, tdiv = post, N = r1*r2;
* stage b: the (pre*r1, r2, post) view, g = r1, the scale.

The emulation below follows that index scheme in torch on the CPU, in f32,
with the radix-16 butterfly as the kernel computes it.  It checks that every
load stays inside its plane, that every exchange writes each word of the
block's buffer once and every read finds a written word, that every output
element is written once and nothing is written for a column at or past V;
and it is held against ``fft_cols_tw_plain``/``a0fs_stage_plain``, numpy in
float64 and the JAX ``_runner_cols_tw`` and ``fft_axis0_fourstep`` (both
stages of ``_runner_a0fs``) in interpret mode: every n1 of the four-step
last axis (n = 4096..2^22, n2 reduced to keep n1*n2 <= 2^18), every
(r1, r2) split of the leading-axis four-step (n = 64..4096), both signs,
f32 and bf16 planes for the a0fs stages, ragged V.  f32: within
``tolerance(n)``.  bf16: within ``PLAIN_LIMIT`` = 1e-3 of the plain version
(both compute in f32 and round each stage's output to bf16 once), within
``tolerance(n, "complex32")`` of float64 and of JAX (whose 'hd' stage dots
carry bf16-rounded matrices).

The instance dispatch of csrc/fourstep.cu (``fs_max``, ``with_fs_list``) is
read from the source and held against every factor the plans send.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps

from regent_fft_tpu_torch.ops import fourstep as fs
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

PLAIN_LIMIT = 1e-3
SMEM_MAX = 232448
CSRC = Path(__file__).resolve().parent.parent / "regent_fft_tpu_torch" / "csrc"
CASES = {int(m.group(1)): (int(m.group(2)), int(m.group(3)), int(m.group(4)),
                           tuple(int(v) for v in m.group(5).split(",")))
         for m in re.finditer(
             r"COLS_CASE\((\d+), (\d+), (\d+), (\d+), ([0-9, ]+)\)",
             (CSRC / "cols.cuh").read_text())}
A0FS_LENGTHS = [1 << k for k in range(6, 13)]                # 64..4096
FOUR_STEP_LENGTHS = [n for n in (1 << k for k in range(12, 23))
                     if sk.four_step_supported(n)]           # 4096..2^22
N1S = sorted({sk._four_step_split(n)[0] for n in FOUR_STEP_LENGTHS})
SIGNS = [-1, 1]


def _fs_dispatch():
    """(smallest length, largest f32 twiddle length, largest otherwise) of
    csrc/fourstep.cu's instance dispatch."""
    src = (CSRC / "fourstep.cu").read_text()
    hi = re.search(r"sizeof\(T\) == 4 && TW \? (\d+) : (\d+);", src)
    lo = re.search(r"if constexpr \(N >= (\d+) && N <= fs_max<T, TW>\(\)"
                   r" && \(N & \(N - 1\)\) == 0\)", src)
    assert hi and lo
    return int(lo.group(1)), int(hi.group(1)), int(hi.group(2))


def test_lengths_the_plans_send():
    """Every four-step last axis splits into n1 = 8..2048 and n2 <= 2048;
    every leading-axis four-step into r1, r2 in {8, 16, 32, 64}."""
    assert FOUR_STEP_LENGTHS == [1 << k for k in range(12, 23)]
    assert N1S == [1 << k for k in range(3, 12)]
    for n in A0FS_LENGTHS:
        r1, r2 = sk._a0fs_split(n)
        assert r1 * r2 == n and 8 <= r1 <= r2 <= 64
        assert jps._a0fs_split(n) == (r1, r2)


@pytest.mark.parametrize("role,n", [("fft_cols_tw", n)
                                    for n in FOUR_STEP_LENGTHS]
                         + [("a0fs", n) for n in A0FS_LENGTHS])
def test_every_factor_has_its_instance(role, n):
    """The factor each pass runs has a COLS_CASE row with the cols_stages
    list, and csrc/fourstep.cu compiles it for the plane types the pass
    takes (fft_cols_tw: f32 with the twiddle; a0fs: both types, stage a
    with the twiddle, stage b without)."""
    lo, hi_tw32, hi = _fs_dispatch()
    if role == "fft_cols_tw":
        factors = [(sk._four_step_split(n)[0], hi_tw32)]
    else:
        factors = [(r, hi) for r in sk._a0fs_split(n)]
    for r, top in factors:
        assert lo <= r <= top and r & (r - 1) == 0, (role, n, r)
        e, cf, cb, rad = CASES[r]
        assert rad == sk.cols_stages(r)
        for cols in (cf, cb):
            assert (r // e) * cols <= 1024


def _geometry(n, dtype):
    """ColsGeo of the instance: E values a thread, C columns and TPC * C
    threads a block, BUFS shared buffers."""
    e, cf, cb, rad = CASES[n]
    c = cf if dtype == torch.float32 else cb
    tpc = n // e
    threads = tpc * c
    minb = max(1, 512 // threads)
    buf = 8 * n * c
    s = len(rad)
    bufs = 0 if s < 2 else (2 if s > 2 and 2 * buf * minb <= SMEM_MAX
                            else 1)
    return dict(E=e, C=c, TPC=tpc, THREADS=threads, BUFS=bufs)


def _at(x, c, cols):
    """Word of element x of column c in a buffer of C = cols columns."""
    if cols >= 32:
        return x * cols + c
    g = 32 // cols
    lg = g.bit_length() - 1
    return ((x >> lg) << 5) + ((x ^ (x >> 4)) & (g - 1)) * cols + c


def _mat(q, sign):
    k = np.arange(q)
    return torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(k, k) / q)
                            .astype(np.complex64))


def _dft(v, r, sign):
    """R-point DFTs along the last axis of complex64 v; radix 16 as the
    kernel's Dft<16> (4-point DFTs, the W16 rotations, 4-point DFTs)."""
    if r != 16:
        return torch.einsum("kr,...r->...k", _mat(r, sign), v)
    t = v.reshape(v.shape[:-1] + (4, 4))                    # [a, b]
    u = torch.einsum("ka,...ab->...kb", _mat(4, sign), t)   # [k1, b]
    kb = np.outer(np.arange(4), np.arange(4))
    u = u * torch.from_numpy(np.exp(sign * 2j * np.pi * kb / 16)
                             .astype(np.complex64))
    y = torch.einsum("...kb,qb->...kq", u, _mat(4, sign))   # [k1, k2]
    return y.transpose(-1, -2).reshape(v.shape)             # k = k1 + 4*k2


def _emulate(xr, xi, sign, g=1, tdiv=1, lN=0, scale=1.0, chunk=256):
    """fft_cols_fs_kernel on (P, n, V) planes, blocks in chunks of
    ``chunk``, every thread of a chunk at once; the store policy of
    (g, tdiv, lN, scale) as the C entries pass it (lN = 0: no twiddle)."""
    p_, n, v_ = xr.shape
    rad = sk.cols_stages(n)
    geo = _geometry(n, xr.dtype)
    cols, tpc = geo["C"], geo["TPC"]
    tid = torch.arange(geo["THREADS"])
    c, lane = tid % cols, tid // cols
    ntiles = -(-v_ // cols)
    total = p_ * n * v_
    x = torch.complex(xr.float(), xi.float()).reshape(-1)
    nan = complex(float("nan"), float("nan"))
    y = torch.full((total,), nan, dtype=torch.complex64)
    count = torch.zeros(total, dtype=torch.int64)
    tab = sk._stage_tables(rad, sign)
    tw = torch.complex(torch.from_numpy(tab[:, 0]),
                       torch.from_numpy(tab[:, 1]))
    for b0 in range(0, p_ * ntiles, chunk):
        blk = torch.arange(b0, min(b0 + chunk, p_ * ntiles))
        q, tile = blk // ntiles, blk % ntiles
        col = tile[:, None] * cols + c                      # (blk, thr)
        valid = col < v_
        off = q[:, None] * n * v_ + torch.where(
            valid, col, torch.full_like(col, v_ - 1))
        lo = (q * n * v_)[:, None, None, None]
        ooff = ((q // g) * g * n + q % g)[:, None] * v_ + col
        bufs = [torch.full((len(blk), n * cols), nan, dtype=torch.complex64)
                for _ in range(max(1, geo["BUFS"]))]
        ns, off_tw = 1, 0
        for st, r in enumerate(rad):
            m = n // r
            nb = -(-m // tpc)
            jraw = lane[:, None] + torch.arange(nb) * tpc   # (thr, nb)
            j = jraw.clamp(max=m - 1)                       # repeat the last
            keep = jraw < m
            idx = j[..., None] + torch.arange(r) * m        # (thr, nb, r)
            if st == 0:                                     # device memory
                assert nb * tpc == m and nb * r == geo["E"]
                flat = off[:, :, None, None] + idx[None] * v_
                assert bool(((flat >= lo) & (flat < lo + n * v_)).all()), \
                    "load outside its plane"
                v = x[flat]
            else:                                           # shared buffer
                a = _at(idx, c[:, None, None], cols)
                v = bufs[(st - 1) % geo["BUFS"]][:, a]
                assert not torch.isnan(v.real).any(), "read of an unwritten word"
            k = j % ns
            if ns > 1:
                w = tw[off_tw + (torch.arange(1, r) - 1) * ns + k[..., None]]
                v = torch.cat([v[..., :1], v[..., 1:] * w], -1)
            v = _dft(v, r, sign)
            if st == len(rad) - 1:                          # the store policy
                assert ns * r == n
                kout = (j[..., None] + torch.arange(r) * ns)[None]
                flat = ooff[:, :, None, None] + kout * (g * v_)
                # a column at or past V stores nothing
                sel = (valid[:, :, None, None] & keep[None, :, :, None]
                       ).expand(v.shape)
                got = flat.expand(v.shape)[sel]
                val = v[sel]
                if lN:
                    e = (kout * (col // tdiv)[:, :, None, None]
                         ).expand(v.shape)[sel]
                    assert int(e.max()) < 2 ** lN <= 2 ** 24
                    th = (e.double() * 2.0 ** (1 - lN)) * np.pi
                    val = val * torch.complex(torch.cos(th).float(),
                                              sign * torch.sin(th).float())
                else:
                    val = val * scale
                assert bool(((got >= 0) & (got < total)).all())
                count.index_add_(0, got, torch.ones_like(got))
                y[got] = val
            else:
                base = (j - k) * r + k
                a = _at(base[..., None] + torch.arange(r) * ns,
                        c[:, None, None], cols)
                sel = keep[..., None].expand(a.shape)
                assert sorted(a[sel].tolist()) == list(range(n * cols)), \
                    "exchange layout"
                buf = bufs[st % geo["BUFS"]]
                buf.fill_(nan)
                buf[:, a[sel]] = v[:, sel]
            off_tw += (r - 1) * ns
            ns *= r
        assert off_tw == len(tw)
    assert bool((count == 1).all()), "an output element written twice or never"
    y = y.reshape(p_, n, v_)
    return y.real.to(xr.dtype).contiguous(), y.imag.to(xr.dtype).contiguous()


def _c(yr, yi):
    return yr.double().numpy() + 1j * yi.double().numpy()


def _fft(x, axis, sign):
    return (np.fft.fft(x, axis=axis) if sign < 0
            else np.fft.ifft(x, axis=axis, norm="forward"))


def _planes(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(xr).to(dtype), torch.from_numpy(xi).to(dtype)


def _cols_tw(xr, xi, sign):
    """The C entry fft_cols_tw's arguments: g = 1, tdiv = 1, N = n1*n2."""
    _, n1, n2 = xr.shape
    return _emulate(xr, xi, sign, 1, 1, (n1 * n2).bit_length() - 1)


def _a0fs(stage, xr, xi, sign, scale=1.0):
    """The C entries a0fs_a / a0fs_b on (pre, n, post) planes."""
    pre, n, post = xr.shape
    r1, r2 = sk._a0fs_split(n)
    if stage == "a":
        yr, yi = _emulate(xr.reshape(pre, r1, r2 * post),
                          xi.reshape(pre, r1, r2 * post), sign, 1, post,
                          n.bit_length() - 1)
    else:
        yr, yi = _emulate(xr.reshape(pre * r1, r2, post),
                          xi.reshape(pre * r1, r2, post), sign, r1, 1, 0,
                          scale)
    return yr.reshape(pre, n, post), yi.reshape(pre, n, post)


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("n1", N1S)
def test_cols_tw_emulation_matches_plain_and_jax(n1, sign):
    """fft_cols_tw at n2 = the four-step's (reduced to keep n1*n2 <= 2^18)
    and at a ragged n2 below one tile, P = 2."""
    cols = _geometry(n1, torch.float32)["C"]
    full = min(max(n for n in FOUR_STEP_LENGTHS
                   if sk._four_step_split(n)[0] == n1), 1 << 18) // n1
    for n2 in (full, cols // 2):
        xr, xi = _planes((2, n1, n2), n1 + n2 + (sign > 0))
        er, ei = _cols_tw(xr, xi, sign)
        emu = _c(er, ei)
        tol = tolerance(n1 * n2)
        assert rel_l2(emu, _c(*fs.fft_cols_tw_plain(xr, xi, sign))) <= tol
        xd = _c(xr, xi)
        k1 = np.arange(n1)[:, None]
        j2 = np.arange(n2)[None, :]
        ref = _fft(xd, 1, sign) * np.exp(sign * 2j * np.pi * k1 * j2
                                         / (n1 * n2))
        assert rel_l2(emu, ref) <= tol
        # the JAX runner on the rows the four-step gives it, P padded to its
        # block of bp planes
        bp = max(1, jps.LANE_TILE // n1)
        vt = min(jps._vt_cap(n1), n2)
        if n2 % vt:
            continue
        pad = -2 % bp
        jr = np.concatenate([xr.numpy(), np.zeros((pad, n1, n2), np.float32)])
        ji = np.concatenate([xi.numpy(), np.zeros((pad, n1, n2), np.float32)])
        run = jps._runner_cols_tw(n1, n1 * n2, sign, vt, True)
        ar, ai = run(jnp.asarray(jr.reshape(-1, n2)),
                     jnp.asarray(ji.reshape(-1, n2)))
        yj = (np.asarray(ar, np.float64) + 1j * np.asarray(ai, np.float64)
              ).reshape(-1, n1, n2)[:2]
        assert rel_l2(emu, yj) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("n", A0FS_LENGTHS)
def test_a0fs_emulation_matches_plain_and_jax(n, sign, dtype):
    """Both stages on the (n, 8, 128) array the JAX gate admits (pre = 1,
    post = 1024), then on ragged (2, n, 37) planes (pre = 2, V = r2*37)
    against the plain versions.  bf16 planes whose r1 is below 16 run on
    f32 planes and come back f32, as in both packages."""
    tdt = getattr(torch, dtype)
    r1, _ = sk._a0fs_split(n)
    bf = tdt == torch.bfloat16 and r1 >= 16
    kdt = torch.bfloat16 if bf else torch.float32
    lim = PLAIN_LIMIT if bf else tolerance(n)
    tol = tolerance(n, "complex32") if bf else tolerance(n)
    scale = 1.0 / n if sign > 0 else 1.0
    for shape in ((n, 8, 128), (2, n, 37)):
        xr, xi = _planes(shape, n + (sign > 0), tdt)
        pre, post = (1, 1024) if shape[1] == 8 else (2, 37)
        tr = xr.to(kdt).reshape(pre, n, post)
        ti = xi.to(kdt).reshape(pre, n, post)
        ar, ai = _a0fs("a", tr, ti, sign)
        assert ar.dtype == kdt
        pa = fs.a0fs_stage_plain("a", tr, ti, sign)
        assert rel_l2(_c(ar, ai), _c(*pa)) <= lim
        # stage b on the plain stage a's output, and on the emulated one
        yr, yi = _a0fs("b", *pa, sign, scale)
        assert rel_l2(_c(yr, yi), _c(*fs.a0fs_stage_plain("b", *pa, sign,
                                                          scale))) <= lim
        yr, yi = _a0fs("b", ar, ai, sign, scale)
        emu = _c(yr, yi).reshape(shape)
        ref = _fft(_c(tr, ti), 1, sign).reshape(shape) * scale
        assert rel_l2(emu, ref) <= tol
        if shape[1] != 8:
            continue
        jr, ji = jps.fft_axis0_fourstep(
            jnp.asarray(xr.float().numpy(), getattr(jnp, dtype)),
            jnp.asarray(xi.float().numpy(), getattr(jnp, dtype)), 0,
            JDirection(sign), scale=scale, interpret=True)
        assert (jr.dtype == jnp.bfloat16) == bf
        yj = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
        assert rel_l2(emu, yj) <= tol


@pytest.mark.parametrize("stage", ["fft_cols_tw", "a", "b"])
def test_wrapper_cpu_planes_run_the_plain_version(stage):
    """CPU planes never reach the four-step kernel: the wrapper runs the
    plain version and counts no launch."""
    shape = (2, 16, 256) if stage == "fft_cols_tw" else (2, 256, 37)
    xr, xi = _planes(shape, 5)
    before = dict(sk.LAUNCHES)
    if stage == "fft_cols_tw":
        got = fs.fft_cols_tw(xr, xi, 1)
        want = fs.fft_cols_tw_plain(xr, xi, 1)
    else:
        scale = 0.25 if stage == "b" else 1.0
        got = fs.a0fs_stage(stage, xr, xi, 1, scale)
        want = fs.a0fs_stage_plain(stage, xr, xi, 1, scale)
    assert sk.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", [
    "fft_tile", "cols_pass", "ColsOut", "cols_geo", "cols_smem_bytes",
    "struct Geo", "stage<R>", "constexpr int ELEMS = 16",
    "constexpr int THREADS = 512", "twiddle_pow2",
    "fft_cols_tw_kernel", "a0fs_a_kernel", "a0fs_b_kernel"])
def test_the_shared_tile_is_gone(name):
    """No kernel source keeps the shared-memory tile of the first port."""
    for src in sorted(CSRC.glob("*.cu*")):
        code = re.sub(r"//[^\n]*", "", src.read_text())
        assert name not in code, (name, src.name)


@pytest.mark.parametrize("name", ["_kernel_stages", "_kernel_tables"])
def test_the_shared_tile_schedule_is_gone(name):
    assert not hasattr(sk, name)
