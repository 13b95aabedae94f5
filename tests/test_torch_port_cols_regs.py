"""The column kernel of ``fft_cols``/``fft_axis0`` (csrc/cols.cu,
``fft_cols_kernel``) emulated on the CPU.

A column of n points is held by TPC = n / E threads (E values each, from
the instance table), a block takes C neighbouring columns of one plane:
thread t is column t % C, lane t // C.  Stage 0 reads device memory
directly (lane j of a column takes elements j + r*M, r < R0, the columns
across the lanes of a warp), every later stage reads the shared buffer the
stage before it wrote (buffer s % BUFS; element x of column c at x*C + c,
or XOR-swizzled within 32-word rows when C < 32), and the last stage
writes device memory directly with the scale.  A stage of radix R gives
each thread ceil((n/R) / TPC) butterflies; a thread past the last repeats
it and drops its stores; the ragged last tile reads column V-1 for its
columns at or past V and stores nothing there.

The emulation below follows that index scheme in torch on the CPU, in f32
(complex64), with the radix-16 butterfly as the kernel computes it (two
levels of 4-point DFTs joined by the W16 rotations).  It checks that every
load stays inside its plane, that every exchange writes each word of the
block's buffer once, that every read finds a written word and that every
output element is written once; it counts the exchanges' bank conflicts;
and it is held against ``fft_cols_plain`` and the JAX ``_runner_cols`` in
interpret mode at every length ``kernel_len_ok(n, False)`` admits up to
``MAX_STOCKHAM_N``, both signs, f32 and bf16 planes, P in {1, 3} and V in
{1, 37, one tile, one tile + 1}.  f32: within ``tolerance(n)``.  bf16:
within ``PLAIN_LIMIT`` = 1e-3 of the plain version and of JAX (all compute
in f32 and round the output to bf16 once), and within
``tolerance(n, "complex32")`` of float64.

The instance table that csrc/cols.cu compiles (``COLS_CASE`` in
csrc/cols.cuh: length, E, columns a block in f32 and in bf16, stage list)
is read from the source and held against ``cols_stages``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.ops import pallas_stockham as jps

from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

LENGTHS = [n for n in range(2, sk.MAX_STOCKHAM_N + 1)
           if sk.kernel_len_ok(n, False)]
PLAIN_LIMIT = 1e-3
SMEM_MAX = 232448
COLS_CU = (Path(__file__).resolve().parent.parent
           / "regent_fft_tpu_torch" / "csrc" / "cols.cuh")
CASES = {int(m.group(1)): (int(m.group(2)), int(m.group(3)), int(m.group(4)),
                           tuple(int(v) for v in m.group(5).split(",")))
         for m in re.finditer(
             r"COLS_CASE\((\d+), (\d+), (\d+), (\d+), ([0-9, ]+)\)",
             COLS_CU.read_text())}
# shared-memory exchanges of each length's stage list
EXCHANGES = {2: 0, 4: 0, 8: 0, 16: 0, 24: 1, 32: 1, 40: 1, 48: 1, 56: 1,
             64: 1, 96: 2, 128: 1, 160: 2, 192: 2, 224: 2, 256: 1, 384: 2,
             512: 2, 640: 2, 768: 2, 896: 2, 1024: 2, 1536: 3, 2048: 2}


def test_admitted_lengths():
    """The 24 lengths of the mid-axis gate: powers of two 2..2048 and the
    mixed lengths mt * 4^s with n % 8 == 0."""
    assert LENGTHS == [2, 4, 8, 16, 24, 32, 40, 48, 56, 64, 96, 128, 160,
                       192, 224, 256, 384, 512, 640, 768, 896, 1024, 1536,
                       2048]
    for n in LENGTHS:
        assert jps.kernel_len_ok(n, False)


@pytest.mark.parametrize("n", LENGTHS)
def test_cols_stage_list(n):
    """The radices multiply to n; radix 16 while it fits, then at most one
    power of two below 16, then the odd factor; every Ns a power of two;
    the exchange count is pinned (at most two at a power of two, three at
    1536); the twiddle table holds (R-1)*Ns entries a stage."""
    rad = sk.cols_stages(n)
    assert int(np.prod(rad)) == n
    assert set(rad) <= {2, 3, 4, 5, 7, 8, 16}
    pow2 = [r for r in rad if r & (r - 1) == 0]
    odd = [r for r in rad if r & (r - 1)]
    assert rad == tuple(pow2 + odd) and len(odd) <= 1
    assert pow2[:-1] == [16] * (len(pow2) - 1)
    ns = 1
    for r in rad:
        assert ns & (ns - 1) == 0
        ns *= r
    assert len(rad) - 1 == EXCHANGES[n]
    assert EXCHANGES[n] <= (2 if n & (n - 1) == 0 else 3)
    tab = sk._stage_tables(rad, -1)
    assert tab.shape == (sum((r - 1) * s for r, s in
                             zip(rad, np.cumprod((1,) + rad[:-1]))), 2)


def _geometry(n, dtype):
    """The instance's geometry as csrc/cols.cu derives it (ColsGeo): E
    values a thread, C columns and TPC * C threads a block, MINB resident
    blocks the launch bounds ask for, BUFS shared buffers."""
    e, cf, cb, rad = CASES[n]
    c = cf if dtype == torch.float32 else cb
    tpc = n // e
    threads = tpc * c
    minb = max(1, 512 // threads)
    buf = 8 * n * c
    s = len(rad)
    bufs = 0 if s < 2 else (2 if s > 2 and 2 * buf * minb <= SMEM_MAX
                            else 1)
    return dict(E=e, C=c, TPC=tpc, THREADS=threads, MINB=minb, BUFS=bufs,
                SMEM=bufs * buf)


def test_c_instances_match_cols_stages():
    """csrc/cols.cu compiles one instance per admitted length with the stage
    list of cols_stages; each thread's E values are whole first-radix
    butterflies, every block fits (at most 1024 threads, 227 KB of shared
    memory, MINB of them an SM), f32 row runs are 64 B or more up to
    n = 1024 and bf16 runs 32 B or more up to 1024."""
    assert set(CASES) == set(LENGTHS)
    for n in LENGTHS:
        e, _, _, rad = CASES[n]
        assert rad == sk.cols_stages(n), n
        assert e % rad[0] == 0 and n % e == 0 and e in (rad[0], 2 * rad[0])
        for dt, size in ((torch.float32, 4), (torch.bfloat16, 2)):
            g = _geometry(n, dt)
            assert g["C"] & (g["C"] - 1) == 0 and g["THREADS"] <= 1024
            assert g["SMEM"] * g["MINB"] <= SMEM_MAX, (n, dt)
            if n <= 1024:
                assert g["C"] * size >= (64 if size == 4 else 32), (n, dt)


def _at(x, c, cols):
    """Word of element x of column c in a buffer of C = cols columns."""
    if cols >= 32:
        return x * cols + c
    g = 32 // cols
    lg = g.bit_length() - 1
    return ((x >> lg) << 5) + ((x ^ (x >> 4)) & (g - 1)) * cols + c


def _dft(v, r, sign):
    """R-point DFTs along the last axis of complex64 v, y[k] = sum_r v[r] *
    exp(sign*2*pi*i*r*k/R); radix 16 as the kernel's Dft<16>: with
    r = 4a + b and k = k1 + 4*k2, 4-point DFTs over a, W16^(b*k1), 4-point
    DFTs over b."""
    def mat(q):
        k = np.arange(q)
        return torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(k, k) / q)
                                .astype(np.complex64))
    if r != 16:
        return torch.einsum("kr,...r->...k", mat(r), v)
    t = v.reshape(v.shape[:-1] + (4, 4))                    # [a, b]
    u = torch.einsum("ka,...ab->...kb", mat(4), t)          # [k1, b]
    kb = np.outer(np.arange(4), np.arange(4))
    u = u * torch.from_numpy(np.exp(sign * 2j * np.pi * kb / 16)
                             .astype(np.complex64))
    y = torch.einsum("...kb,qb->...kq", u, mat(4))          # [k1, k2]
    return y.transpose(-1, -2).reshape(v.shape)             # k = k1 + 4*k2


def _threads(n, dtype):
    g = _geometry(n, dtype)
    tid = torch.arange(g["THREADS"])
    return g, tid % g["C"], tid // g["C"]


def _emulate_cols(xr, xi, sign, scale):
    """fft_cols_kernel's index scheme on (P, n, V) planes, every block and
    thread at once: (block, thread, butterfly, r) index tensors."""
    p_, n, v_ = xr.shape
    rad = sk.cols_stages(n)
    g, c, lane = _threads(n, xr.dtype)
    cols, tpc = g["C"], g["TPC"]
    ntiles = -(-v_ // cols)
    blk = torch.arange(p_ * ntiles)
    pre, tile = blk // ntiles, blk % ntiles
    col = tile[:, None] * cols + c                          # (blk, thr)
    valid = col < v_
    off = pre[:, None] * n * v_ + torch.where(valid, col,
                                              torch.full_like(col, v_ - 1))
    lo = (pre * n * v_)[:, None, None, None]
    x = torch.complex(xr.float(), xi.float()).reshape(-1)
    nan = complex(float("nan"), float("nan"))
    y = torch.full((p_ * n * v_,), nan, dtype=torch.complex64)
    bufs = [torch.full((len(blk), n * cols), nan, dtype=torch.complex64)
            for _ in range(max(1, g["BUFS"]))]
    tab = sk._stage_tables(rad, sign)
    tw = torch.complex(torch.from_numpy(tab[:, 0]), torch.from_numpy(tab[:, 1]))
    ns, off_tw = 1, 0
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpc)
        jraw = lane[:, None] + torch.arange(nb) * tpc       # (thr, nb)
        j = jraw.clamp(max=m - 1)                           # repeat the last
        keep = jraw < m
        idx = j[..., None] + torch.arange(r) * m            # (thr, nb, r)
        if st == 0:                                         # device memory
            assert nb * tpc == m and nb * r == g["E"]
            flat = off[:, :, None, None] + idx[None] * v_
            assert bool(((flat >= lo) & (flat < lo + n * v_)).all()), \
                "load outside its plane"
            v = x[flat]
        else:                                               # shared buffer
            a = _at(idx, c[:, None, None], cols)
            v = bufs[(st - 1) % g["BUFS"]][:, a]
            assert not torch.isnan(v.real).any(), "read of an unwritten word"
        k = j % ns
        if ns > 1:
            w = tw[off_tw + (torch.arange(1, r) - 1) * ns + k[..., None]]
            v = torch.cat([v[..., :1], v[..., 1:] * w], -1)
        v = _dft(v, r, sign)
        if st == len(rad) - 1:                              # device memory
            assert ns * r == n
            oidx = j[..., None] + torch.arange(r) * ns
            flat = (off[:, :, None, None] + oidx[None] * v_).expand(v.shape)
            sel = (valid[:, :, None, None] & keep[None, :, :, None]).expand(
                v.shape)
            assert bool(((flat >= lo) & (flat < lo + n * v_)).all())
            got = flat[sel]
            assert len(set(got.tolist())) == len(got) == p_ * n * v_
            y[got] = v[sel] * scale
        else:
            base = (j - k) * r + k
            a = _at(base[..., None] + torch.arange(r) * ns, c[:, None, None],
                    cols)
            sel = keep[..., None].expand(a.shape)
            assert sorted(a[sel].tolist()) == list(range(n * cols)), \
                "exchange layout"
            buf = bufs[st % g["BUFS"]]
            buf.fill_(nan)
            buf[:, a[sel]] = v[:, sel]
        off_tw += (r - 1) * ns
        ns *= r
    assert off_tw == len(tw)
    y = y.reshape(p_, n, v_)
    return y.real.to(xr.dtype), y.imag.to(xr.dtype)


def _bank_replays(n, dtype):
    """The worst count of distinct words one bank serves in a warp-wide
    shared access of fft_cols's exchanges at length n (1: conflict-free),
    over every write and read phase: the (b, r) accesses of each warp of a
    block, 32 banks of 4-byte words; repeated butterflies read the word
    their last one reads, dropped stores write nothing."""
    rad = sk.cols_stages(n)
    g, c, lane = _threads(n, dtype)
    tpc, cols = g["TPC"], g["C"]
    worst, ns = 1, 1
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpc)
        jraw = lane[:, None] + torch.arange(nb) * tpc
        j = jraw.clamp(max=m - 1)
        k = j % ns
        phases = []
        if st > 0:
            reads = _at(j[..., None] + torch.arange(r) * m, c[:, None, None],
                        cols)
            phases.append((reads, torch.ones_like(reads, dtype=torch.bool)))
        if st < len(rad) - 1:
            base = (j - k) * r + k
            writes = _at(base[..., None] + torch.arange(r) * ns,
                         c[:, None, None], cols)
            phases.append((writes, (jraw < m)[..., None].expand(writes.shape)))
        for addr, live in phases:
            for w0 in range(0, g["THREADS"], 32):
                a_w, l_w = addr[w0:w0 + 32], live[w0:w0 + 32]
                for b in range(nb):
                    for q in range(r):
                        a = a_w[:, b, q][l_w[:, b, q]]
                        banks = a % 32
                        for bank in set(banks.tolist()):
                            worst = max(worst, len(set(
                                a[banks == bank].tolist())))
        ns *= r
    return worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [n for n in LENGTHS if n > 16])
def test_exchanges_bank_conflicts(n, dtype):
    """Tiles of 32 columns or more take one x a warp access, 32 neighbouring
    words; narrower tiles (640-2048 in f32, 384-2048 in bf16) swizzle their
    32-word rows, which keeps the stride-16 writes of the first stage, the
    later stages' writes and the unit-stride reads on distinct banks: every
    exchange at every length is free of bank conflicts, the mixed lengths'
    ragged odd stage included."""
    assert _bank_replays(n, dtype) == 1


def _shapes(n, dtype):
    """(P, V) of the emulated cases: P in {1, 3}, V in {1, 37, one tile,
    one tile + 1}."""
    cols = _geometry(n, dtype)["C"]
    return [(p_, v_) for p_ in (1, 3) for v_ in (1, 37, cols, cols + 1)]


def _c(yr, yi):
    return yr.double().numpy() + 1j * yi.double().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_column_emulation_matches_plain_and_jax(n, sign, dtype):
    tdt = getattr(torch, dtype)
    cases = _shapes(n, tdt)
    vmax = max(v_ for _, v_ in cases)
    rng = np.random.default_rng(n + (sign > 0))
    xr = rng.standard_normal((3, n, vmax)).astype(np.float32)
    xi = rng.standard_normal((3, n, vmax)).astype(np.float32)
    tr, ti = torch.from_numpy(xr).to(tdt), torch.from_numpy(xi).to(tdt)
    scale = 1.0 / np.sqrt(n)
    # the JAX runner once over the widest input (columns are independent)
    run = jps._runner_cols(n, sign, vmax, scale, True,
                           "bf16" if dtype == "bfloat16" else "f32")
    jr, ji = run(jnp.asarray(xr.reshape(3 * n, vmax), getattr(jnp, dtype)),
                 jnp.asarray(xi.reshape(3 * n, vmax), getattr(jnp, dtype)))
    yj = (np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
          ).reshape(3, n, vmax)
    bf = dtype == "bfloat16"
    tol = tolerance(n, "complex32" if bf else "complex64")
    lim = PLAIN_LIMIT if bf else tolerance(n)
    for p_, v_ in cases:
        cr = tr[:p_, :, :v_].contiguous()
        ci = ti[:p_, :, :v_].contiguous()
        er, ei = _emulate_cols(cr, ci, sign, scale)
        assert er.dtype == ei.dtype == tdt
        emu = _c(er, ei)
        assert rel_l2(emu, _c(*sk.fft_cols_plain(cr, ci, sign, scale))) <= lim
        assert rel_l2(emu, yj[:p_, :, :v_]) <= lim
        xd = _c(cr, ci)
        ref = (np.fft.fft(xd, axis=1) if sign < 0
               else np.fft.ifft(xd, axis=1, norm="forward")) * scale
        assert rel_l2(emu, ref) <= tol


@pytest.mark.parametrize("n", [512, 640, 2048])
def test_axis0_emulation_matches_plain(n):
    """fft_axis0 is the f32 instance with P = 1: the emulation of (1, n, V)
    planes against fft_axis0_plain (the JAX _runner_axis0 body)."""
    rng = np.random.default_rng(n)
    v_ = _geometry(n, torch.float32)["C"] * 2 + 3
    xr = torch.from_numpy(rng.standard_normal((n, v_)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((n, v_)).astype(np.float32))
    er, ei = _emulate_cols(xr[None], xi[None], -1, 1.0)
    pr, pi = sk.fft_axis0_plain(xr, xi, -1, 1.0)
    assert rel_l2(_c(er[0], ei[0]), _c(pr, pi)) <= tolerance(n)


@pytest.mark.parametrize("name", ["fft_cols", "fft_axis0"])
def test_wrapper_cpu_planes_run_the_plain_version(name):
    """CPU planes never reach the column kernel: the wrapper runs the plain
    version and counts no launch."""
    rng = np.random.default_rng(11)
    shape = (3, 640, 37) if name == "fft_cols" else (640, 37)
    xr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = dict(sk.LAUNCHES)
    yr, yi = getattr(sk, name)(xr, xi, 1, 0.25)
    assert sk.LAUNCHES == before
    pr, pi = getattr(sk, name + "_plain")(xr, xi, 1, 0.25)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
