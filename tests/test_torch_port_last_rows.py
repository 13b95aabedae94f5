"""The row kernel of ``fft_last`` (csrc/stockham.cu, ``fft_last_kernel``, on
the row body of csrc/last.cuh) emulated on the CPU.

A row of n points is held by T = n / R0 threads (R0 the first radix of
``last_stages``), each with its values in registers; a block is
``last_geometry(n)[1]`` rows.  Stage 0 reads device memory directly
(thread j of a row takes elements j + r*T), every later stage reads the
shared buffer the stage before it wrote (buffer s % 2, rows at a pitch,
words swizzled or padded), and the last stage writes device memory
directly with the scale.  A stage of radix R gives each thread
ceil((n/R) / T) butterflies; a thread past the last repeats it and drops
its stores; the ragged last block reads its last row again and stores
nothing past B.

The emulation below follows that index scheme in torch on the CPU, in f32
(complex64), with the radix-16 butterfly as the kernel computes it (two
levels of 4-point DFTs joined by the W16 rotations).  It checks that every
exchange writes each word of each row's part of the buffer once and that
every read finds a written word, and it is held against ``fft_last_plain``
and the JAX ``_runner_last`` in interpret mode at every length
``kernel_len_ok(n, True)`` admits, both signs, f32 and bf16 planes, B = 1
and a B that leaves a ragged last block.  f32: within ``tolerance(n)``.
bf16: within ``PLAIN_LIMIT`` = 1e-3 of the plain version and of JAX (both
compute in f32 and round the output to bf16 once, so they differ only where
two f32 results straddle a bf16 rounding boundary; the chip check holds the
kernel to the same limit), and within ``tolerance(n, "complex32")`` of
float64.

The stage lists and block size that csrc/last.cuh compiles (its
``LAST_CASE`` table and ``LAST_BLOCK``) are read from the source and held
against ``last_stages`` and ``LAST_BLOCK``; and the plans' table prefetch
(``Plan.table_keys``, from the kernel modules' key functions) names
``last_stages`` for every step that runs ``fft_last`` or the real row-pair
kernels, ``cols_stages`` for the column kernels (the mid-axis ``stockham``
steps' ``fft_cols`` and ``fft_axis0``, the axis ring, ``fft_cols_tw`` and
both four-step stages), ``fused2_stages`` for both axes of the two-axis
ring, and for the fused pair the list of the body it runs
(``fused2_regs_stages`` at 512^2).  With the launches stubbed, every plan
fetches exactly the tables it prefetches.
"""
import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.ops import pallas_stockham as jps

from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.dtypes import Direction, Kind
from regent_fft_tpu_torch.ops import _build
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

LENGTHS = [n for n in range(2, sk.MAX_LAST_N + 1) if sk.kernel_len_ok(n, True)]
PLAIN_LIMIT = 1e-3
LAST_CUH = (Path(__file__).resolve().parent.parent
            / "regent_fft_tpu_torch" / "csrc" / "last.cuh")


def test_admitted_lengths():
    """The 16 lengths of the last-axis gate: powers of two 2..2048 and the
    mixed lengths mt * 4^s with n % 128 == 0."""
    assert LENGTHS == [2, 4, 8, 16, 32, 64, 128, 256, 384, 512, 640, 768,
                       896, 1024, 1536, 2048]
    for n in LENGTHS:
        assert jps.kernel_len_ok(n, True)


@pytest.mark.parametrize("n", LENGTHS)
def test_last_stage_list(n):
    """The radices multiply to n; radix 16 while it fits, then at most one
    power of two below 16, then the odd factor; every Ns a power of two;
    at most two exchanges of shared memory at a power of two, three at a
    mixed length; stage 0 gives every thread of a row exactly one
    butterfly; the twiddle table holds (R-1)*Ns entries a stage."""
    rad = sk.last_stages(n)
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
    exchanges = len(rad) - 1
    assert exchanges <= (2 if n & (n - 1) == 0 else 3)
    tpr, rpb = sk.last_geometry(n)
    assert tpr * rad[0] == n and (n < 16 or rad[0] == 16)
    assert rpb == max(1, sk.LAST_BLOCK // tpr) and tpr * rpb <= sk.LAST_BLOCK
    tab = sk._stage_tables(rad, -1)
    assert tab.shape == (sum((r - 1) * s for r, s in
                             zip(rad, np.cumprod((1,) + rad[:-1]))), 2)


def test_c_instances_match_last_stages():
    """csrc/last.cuh (the row body stockham.cu's fft_last_kernel runs)
    compiles one instance per admitted length, with the stage list of
    last_stages, and blocks of LAST_BLOCK threads."""
    src = LAST_CUH.read_text()
    cases = {int(m.group(1)): tuple(int(v) for v in m.group(2).split(","))
             for m in re.finditer(r"LAST_CASE\((\d+), ([0-9, ]+)\)", src)}
    assert cases == {n: sk.last_stages(n) for n in LENGTHS}
    block = re.search(r"constexpr int LAST_BLOCK = (\d+);", src)
    assert block and int(block.group(1)) == sk.LAST_BLOCK


def _layout(n):
    """Where word x of a row lies in the row's part of a shared buffer, and
    the row pitch: swizzled within 32-word groups from n = 512 on, padded
    one word every 16 below."""
    if n >= 512:
        return (lambda x: x ^ ((x >> 4) & 31)), n
    return (lambda x: x + (x >> 4)), n + n // 16


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


def _emulate_last_rows(xr, xi, sign, scale):
    """fft_last_kernel's index scheme on (B, n) planes, every block and
    thread at once: (block, thread, butterfly, r) index tensors."""
    b_rows, n = xr.shape
    rad = sk.last_stages(n)
    tpr, rpb = sk.last_geometry(n)
    at, pitch = _layout(n)
    words = at(torch.arange(n))
    assert len(set(words.tolist())) == n and int(words.max()) < pitch
    nblk = -(-b_rows // rpb)
    tid = torch.arange(tpr * rpb)
    rl, lane = tid // tpr, tid % tpr
    row = torch.arange(nblk)[:, None] * rpb + rl            # (blk, thr)
    valid = row < b_rows
    src = torch.where(valid, row, torch.full_like(row, b_rows - 1))
    x = torch.complex(xr.float(), xi.float())
    nan = complex(float("nan"), float("nan"))
    y = torch.full((b_rows, n), nan, dtype=torch.complex64)
    bufs = [torch.full((nblk, rpb * pitch), nan, dtype=torch.complex64)
            for _ in range(2)]
    tab = sk._stage_tables(rad, sign)
    tw = torch.complex(torch.from_numpy(tab[:, 0]), torch.from_numpy(tab[:, 1]))
    every_word = sorted((r_ * pitch + words).tolist() for r_ in range(rpb))
    ns, off = 1, 0
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpr)
        jraw = lane[:, None] + torch.arange(nb) * tpr       # (thr, nb)
        j = jraw.clamp(max=m - 1)                           # repeat the last
        keep = jraw < m
        idx = j[..., None] + torch.arange(r) * m            # (thr, nb, r)
        if st == 0:                                         # device memory
            assert nb == 1 and bool(keep.all())
            v = x[src[:, :, None, None], idx[None]]
        else:                                               # shared buffer
            v = bufs[(st - 1) % 2][:, rl[:, None, None] * pitch + at(idx)]
            assert not torch.isnan(v.real).any(), "read of an unwritten word"
        k = j % ns
        if ns > 1:
            w = tw[off + (torch.arange(1, r) - 1) * ns + k[..., None]]
            v = torch.cat([v[..., :1], v[..., 1:] * w], -1)
        v = _dft(v, r, sign)
        if st == len(rad) - 1:                              # device memory
            assert ns * r == n
            oidx = (j[..., None] + torch.arange(r) * ns).expand(v.shape)
            sel = (valid[:, :, None, None] & keep[None, :, :, None]).expand(
                v.shape)
            orow = row[:, :, None, None].expand(v.shape)
            flat = orow[sel] * n + oidx[sel]
            assert len(set(flat.tolist())) == len(flat) == b_rows * n
            y[orow[sel], oidx[sel]] = v[sel] * scale
        else:
            base = (j - k) * r + k
            a = (rl[:, None, None] * pitch
                 + at(base[..., None] + torch.arange(r) * ns))
            sel = keep[..., None].expand(a.shape)
            assert sorted(a[sel].tolist()) == sorted(
                w_ for ws in every_word for w_ in ws), "exchange layout"
            buf = bufs[st % 2]
            buf.fill_(nan)
            buf[:, a[sel]] = v[:, sel]
        off += (r - 1) * ns
        ns *= r
    assert off == len(tw)
    return y.real.to(xr.dtype), y.imag.to(xr.dtype)


def _bank_replays(n):
    """The worst count of distinct words one bank serves in a warp-wide
    shared access of fft_last's exchanges at length n (1: conflict-free),
    over every write and read phase: the (b, r) accesses of each warp of a
    block, 32 banks of 4-byte words; repeated butterflies read the word
    their last one reads, dropped stores write nothing."""
    rad = sk.last_stages(n)
    tpr, rpb = sk.last_geometry(n)
    at, pitch = _layout(n)
    tid = torch.arange(tpr * rpb)
    rl, lane = tid // tpr, tid % tpr
    worst, ns = 1, 1
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpr)
        jraw = lane[:, None] + torch.arange(nb) * tpr
        j = jraw.clamp(max=m - 1)
        k = j % ns
        phases = []
        if st > 0:
            reads = rl[:, None, None] * pitch + at(j[..., None]
                                                   + torch.arange(r) * m)
            phases.append((reads, torch.ones_like(reads, dtype=torch.bool)))
        if st < len(rad) - 1:
            base = (j - k) * r + k
            writes = rl[:, None, None] * pitch + at(base[..., None]
                                                    + torch.arange(r) * ns)
            phases.append((writes, (jraw < m)[..., None].expand(writes.shape)))
        for addr, live in phases:
            for w0 in range(0, len(tid), 32):
                for b in range(nb):
                    for q in range(r):
                        a = addr[w0:w0 + 32, b, q][live[w0:w0 + 32, b, q]]
                        for bank in set((a % 32).tolist()):
                            worst = max(worst, len(set(
                                a[a % 32 == bank].tolist())))
        ns *= r
    return worst


@pytest.mark.parametrize("n", [n for n in LENGTHS if n >= 32])
def test_exchanges_bank_conflicts(n):
    """The row layout (swizzle from 512 on, one pad word every 16 below)
    keeps every exchange of the powers of two free of bank conflicts; the
    mixed lengths, whose odd stage gives threads ragged butterfly counts
    (and rows of 24-96 threads share warps), stay within three words a
    bank (896: three, 384, 640 and 768: two, 1536: one)."""
    assert _bank_replays(n) <= (1 if n & (n - 1) == 0 else 3)


def _batches(n):
    """B = 1 and a B that leaves a ragged last block (rows a block + 1;
    three rows where a block is one row and no block can be ragged)."""
    rpb = sk.last_geometry(n)[1]
    return (1, rpb + 1 if rpb > 1 else 3)


def _c(yr, yi):
    return yr.double().numpy() + 1j * yi.double().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_row_emulation_matches_plain_and_jax(n, sign, dtype):
    b1, b2 = _batches(n)
    rng = np.random.default_rng(n + (sign > 0))
    xr = rng.standard_normal((b1 + b2, n)).astype(np.float32)
    xi = rng.standard_normal((b1 + b2, n)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tr, ti = torch.from_numpy(xr).to(tdt), torch.from_numpy(xi).to(tdt)
    scale = 1.0 / np.sqrt(n)
    # the JAX runner once over both inputs' rows (rows are independent)
    run = jps._runner_last(n, sign, b1 + b2, scale, True,
                           "bf16" if dtype == "bfloat16" else "f32")
    jr, ji = run(jnp.asarray(xr, getattr(jnp, dtype)),
                 jnp.asarray(xi, getattr(jnp, dtype)))
    yj = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
    bf = dtype == "bfloat16"
    tol = tolerance(n, "complex32" if bf else "complex64")
    lim = PLAIN_LIMIT if bf else tolerance(n)
    for rows in (slice(0, b1), slice(b1, b1 + b2)):
        er, ei = _emulate_last_rows(tr[rows], ti[rows], sign, scale)
        assert er.dtype == ei.dtype == tdt
        emu = _c(er, ei)
        assert rel_l2(emu, _c(*sk.fft_last_plain(tr[rows], ti[rows], sign,
                                                 scale))) <= lim
        assert rel_l2(emu, yj[rows]) <= lim
        xd = _c(tr[rows], ti[rows])
        ref = (np.fft.fft(xd, axis=1) if sign < 0
               else np.fft.ifft(xd, axis=1, norm="forward")) * scale
        assert rel_l2(emu, ref) <= tol


def test_wrapper_cpu_planes_run_the_plain_version():
    """CPU planes never reach the row kernel: the wrapper runs the plain
    version and counts no launch."""
    rng = np.random.default_rng(9)
    xr = torch.from_numpy(rng.standard_normal((5, 640)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((5, 640)).astype(np.float32))
    before = dict(sk.LAUNCHES)
    yr, yi = sk.fft_last(xr, xi, 1, 0.25)
    assert sk.LAUNCHES == before
    pr, pi = sk.fft_last_plain(xr, xi, 1, 0.25)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)


def _plan(shape, axes, kind="c2c", switches=None, **kw):
    direction = 1 if kind == "c2r" else -1
    spec = tplan.PlanSpec(shape=shape, axes=axes, kind=Kind(kind),
                          direction=Direction(direction), backend="stockham",
                          device="cpu", **kw)
    return tplan.Plan(spec, switches or tplan.Switches())


def _tables(shape, axes, kind="c2c", **kw):
    return [(n, f.__name__)
            for n, f, _ in _plan(shape, axes, kind, **kw).table_keys]


PREFETCH_CASES = [
    # 1-D C2C rows: fft_last
    ((4096, 1024), (1,), "c2c", [(1024, "last_stages")]),
    ((4096, 640), (1,), "c2c", [(640, "last_stages")]),
    # the four-step last axis: fft_cols_tw over n1, fft_last over n2
    ((64, 1 << 20), (1,), "c2c", [(512, "cols_stages"),
                                  (2048, "last_stages")]),
    # 3-D: the fused pair on the register body (512^2 planes), then the
    # leading axis on fft_cols
    ((512, 512, 512), (0, 1, 2), "c2c", [(512, "fused2_regs_stages"),
                                         (512, "fused2_regs_stages"),
                                         (512, "cols_stages")]),
    # a 3-D grid whose last axis is too short to fuse: fft_last, then the
    # mid and leading axes on fft_cols
    ((8, 16, 64), (0, 1, 2), "c2c", [(64, "last_stages"),
                                     (16, "cols_stages"),
                                     (8, "cols_stages")]),
    # a rank-1 array: its one axis runs fft_cols (pre = post = 1)
    ((1024,), (0,), "c2c", [(1024, "cols_stages")]),
    # the half-length real route: fft_last at n/2
    ((4096, 1024), (1,), "c2r", [(512, "last_stages")]),
    # the row-pair real kernels: the row body's tables; the mid axis runs
    # fft_cols
    ((4096, 1024), (1,), "r2c", [(1024, "last_stages")]),
    ((8, 256, 256), (1, 2), "r2c", [(256, "cols_stages"),
                                    (256, "last_stages")]),
    ((8, 256, 256), (1, 2), "c2r", [(256, "cols_stages"),
                                    (256, "last_stages")]),
    ((4, 256, 256, 256), (1, 2, 3), "c2r", [(256, "cols_stages"),
                                            (256, "cols_stages"),
                                            (256, "last_stages")]),
    # axis 0 of a rank-2 f32 array: fft_axis0
    ((512, 4096), (0,), "c2c", [(512, "cols_stages")]),
    # the ring and four-step routes (kind with the plan's route fields):
    # the axis ring and both four-step stages run fft_cols' column body,
    # the two-axis ring the cluster body's stage walk (the leading axis
    # after it runs fft_cols)
    ((512, 512, 512), (0, 1, 2), ("c2c", {"axis0_impl": "dma"}),
     [(512, "fused2_regs_stages"), (512, "fused2_regs_stages"),
      (512, "cols_stages")]),
    ((512, 512, 512), (0, 1, 2), ("c2c", {"axis0_impl": "fourstep"}),
     [(512, "fused2_regs_stages"), (512, "fused2_regs_stages"),
      (16, "cols_stages"), (32, "cols_stages")]),
    ((512, 512, 512), (0, 1, 2), ("c2c", {"f2_impl": "ring"}),
     [(512, "fused2_stages"), (512, "fused2_stages"),
      (512, "cols_stages")]),
]


@pytest.mark.parametrize("shape,axes,kind,want", PREFETCH_CASES)
def test_plans_prefetch_the_tables_their_kernels_read(shape, axes, kind,
                                                      want):
    kind, kw = kind if isinstance(kind, tuple) else (kind, {})
    assert _tables(shape, axes, kind, **kw) == want


def test_complex32_four_step_prefetch():
    """complex32 takes the same steps and tables (the four-step runs its
    kernels on f32 planes, fft_last_bf16 reads the f32 kernel's table)."""
    assert (_tables((64, 1 << 20), (1,), dtype="complex32")
            == [(512, "cols_stages"), (2048, "last_stages")])
    assert (_tables((4096, 1024), (1,), dtype="complex32")
            == [(1024, "last_stages")])


@pytest.fixture
def fetched(monkeypatch):
    """The wrappers' CUDA side stubbed (planes count as the card's, every C
    entry returns 0, the launch itself runs and counts), and every table
    they fetch recorded as (n, sign, stage list name, table dtype)."""
    got = []
    monkeypatch.setattr(sk, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(sk, "_sm_count", lambda dev: 132)

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    def tables(n, sign, device, stages, dtype):
        got.append((n, sign, stages.__name__, dtype))
        return torch.zeros((1, 2), dtype=dtype), None, 1
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(sk, "device_tables", tables)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    yield got
    sk.reset_launches()


def _named(keys, sign):
    return sorted(((n, sign, f.__name__, dt) for n, f, dt in keys),
                  key=str)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


CUDA = torch.device("cuda")


@pytest.mark.parametrize("shape,axes,kind", [
    c[:3] for c in PREFETCH_CASES] + [
    # complex32: the four-step on f32 planes, fft_last_bf16 on f32 tables
    ((64, 1 << 20), (1,), ("c2c", {"dtype": "complex32"})),
    ((8, 16, 64), (0, 1, 2), ("c2c", {"dtype": "complex32"})),
    # the gap-fused pass (the cluster body's stage walk) and its mid axis
    ((2, 16, 8, 256), (1, 2, 3), ("c2c", {"switches": tplan.Switches(
        gap_fused=True)})),
])
def test_plans_fetch_exactly_the_tables_they_prefetch(fetched, shape, axes,
                                                      kind):
    """Each plan run on its kernels' path (meta planes, launches stubbed)
    asks ``device_tables`` for exactly the keys it prefetches."""
    kind, kw = kind if isinstance(kind, tuple) else (kind, {})
    p = _plan(shape, axes, kind, **kw)
    fetched.clear()
    if kind == "r2c":
        p.execute_real(_meta(shape, p.cdtype))
    else:
        planes = shape if kind == "c2c" else tplan._half_shape(p.spec)
        p.execute_split(_meta(planes, p.cdtype), _meta(planes, p.cdtype))
    assert fetched and _named(p.table_keys, int(p.spec.direction)) == sorted(
        fetched, key=str)
    assert sum(sk.LAUNCHES.values()) >= len(p.steps)


@pytest.mark.parametrize("shape", [(512, 512, 512), (4, 256, 256, 256),
                                   (2, 1024)])
def test_complex128_steps_fetch_the_float64_tables_they_list(fetched, shape):
    """A complex128 plan's steps for the card (the f64 instances of
    fft_cols and fft_last) fetch exactly the float64 tables that
    ``kernel_keys`` lists for them."""
    spec = tplan.PlanSpec(shape=shape, axes=tuple(range(len(shape))),
                          kind=Kind.C2C, direction=Direction.FORWARD,
                          dtype="complex128", device="cpu")
    steps = tplan.axis_steps(spec, "hybrid",
                             sorted(spec.axes, reverse=True), False, CUDA)
    keys = tplan.kernel_keys(steps, shape, torch.float64)
    assert {dt for _, _, dt in keys} == {torch.float64}
    x = _meta(shape, torch.float64)
    tplan.run_steps(steps, x, x, Direction.FORWARD, False)
    assert _named(keys, -1) == sorted(fetched, key=str)
