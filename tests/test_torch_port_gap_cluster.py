"""The gap pass on the cluster kernel (csrc/stockham.cu, the GAP instance
of ``fft_fused2_kernel``; C entries ``fft_gap``, ``fft_gap_bf16``) emulated
on the CPU.

The kernel runs each (b, y) plane of (B, z, Y, x) data on one
thread-block cluster of C CTAs, as ``fft_fused2`` runs a (z, x) plane; only
the addressing differs.  Cluster q takes plane (b, y) = (q // Y, q % Y),
which starts at b*z*ld + y*x, its rows ld = Y*x elements apart.  CTA c
loads the stripe of columns [c*w, (c+1)*w) (w = x/C) four elements a load,
transforms it along z and keeps it in f32; after a cluster barrier it
gathers the rows [c*h, (c+1)*h) (h = z/C), element i from CTA i // w at
column i % w, transforms them along x, and its last stage stores element
X = t*x + i of its rows at c*h*ld + t*ld + i, t found from X by a
multiply-high.  The emulation below takes its addresses from those
formulas (numpy int64, every word read and written accounted for), its
butterflies from the stage list of :func:`fused2_stages` with its
float64-generated twiddle table, and is held against
``fft_axes_gap_plain``, numpy float64 and the JAX ``_runner_fused2_gap``
in interpret mode within ``tolerance(z * x, dtype)``, in f32 and bf16,
both signs.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps

import regent_fft_tpu_torch as rt
from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.ops import _build
from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

SRC = Path(sk.__file__).resolve().parent.parent / "csrc" / "stockham.cu"
MAX_N = sk.MAX_FUSED2_ELEMS // 16
FIRST = [n for n in range(16, MAX_N + 1) if sk._fusable_len(n, False)]
LAST = [n for n in range(128, MAX_N + 1) if sk._fusable_len(n, True)]
PAIRS = [(a, b) for a in FIRST for b in LAST if sk.fused_gap_supported(a, b)]
THREADS = sk.FUSED2_THREADS
INT_MAX = 2 ** 31 - 1


# --- the kernel's addresses ---------------------------------------------------
def _plane(q, shape):
    """Cluster q's plane: its first element and the distance between its
    rows (the kernel's ``plane`` and ``ld``)."""
    _, z, y, x = shape
    ld = y * x
    b = q // y
    return b * z * ld + (q - b * y) * x, ld


def _stripe_reads(shape, c_, qs):
    """(len(qs), C, z, w) addresses of the stripe loads: group g of CTA c
    is row j = g // (w/4), columns 4*(g % (w/4)) .. +3, stored at shared
    word 4g (= j*w + column), so the stripe comes out row-major."""
    _, z, _, x = shape
    w = x // c_
    wq = w // 4
    q = np.asarray(qs, np.int64)[:, None, None, None]
    c = np.arange(c_, dtype=np.int64)[None, :, None, None]
    g = np.arange(z * wq, dtype=np.int64)[None, None, :, None]
    j = g // wq
    base, ld = _plane(q, shape)
    addr = base + c * w + j * ld + 4 * (g - j * wq) + np.arange(4)
    return addr.reshape(len(qs), c_, z, w)


def _last_stage_x(x, h):
    """Every X the last row stage of a CTA stores, in its order: butterfly
    u = (row t, j) of radix R over Ns = the earlier radices' product
    writes X = t*x + (j - j%Ns)*R + j%Ns + r*Ns, r < R."""
    rad = sk.fused2_stages(x)
    r_, ns = rad[-1], int(np.prod(rad[:-1]))
    m = x // r_
    assert -(-sk.FUSED2_CTA_ELEMS // THREADS // r_) * THREADS >= h * m
    u = np.arange(h * m, dtype=np.int64)
    t = u // m
    j = u - t * m
    k = j & (ns - 1)
    xo = t * x + (j - k) * r_ + k
    return (xo[:, None] + np.arange(r_) * ns).ravel()


def _row_writes(shape, c_, qs, xs):
    """(len(qs), C, len(xs)) addresses the CTAs store X = xs at: t = X // x
    by the multiply-high with mag = ceil(2^32 / x), then c*h*ld + X +
    t*(ld - x) past the plane."""
    _, z, _, x = shape
    h = z // c_
    mag = 0xFFFFFFFF // x + 1
    xs = np.asarray(xs, np.int64)
    t = (xs * mag) >> 32
    q = np.asarray(qs, np.int64)[:, None, None]
    c = np.arange(c_, dtype=np.int64)[None, :, None]
    base, ld = _plane(q, shape)
    return base + c * h * ld + xs + t * (ld - x)


def _mixed_radix(shape, qs):
    """The addresses of planes qs in (B, z, Y, x) order: what the kernel
    must read, and write, exactly once."""
    _, z, y, x = shape
    q = np.asarray(qs, np.int64)[:, None, None]
    b, yy = q // y, q % y
    j = np.arange(z, dtype=np.int64)[None, :, None]
    i = np.arange(x, dtype=np.int64)[None, None, :]
    return (((b * z + j) * y + yy) * x + i).ravel()


# --- the emulation ------------------------------------------------------------
def _stages(v, n, sign):
    """fused2_stages' Stockham stages along axis 0 of (n, K) complex64
    columns: stage (R, Ns) reads v[j + r*m], twiddles by table entry
    (r-1)*Ns + j%Ns, runs an R-point DFT and writes
    out[(j - j%Ns)*R + j%Ns + q*Ns]."""
    rad = sk.fused2_stages(n)
    tab = torch.from_numpy(sk._stage_tables(rad, sign))
    tw = torch.complex(tab[:, 0], tab[:, 1])
    ns, off = 1, 0
    for r in rad:
        m = n // r
        j = torch.arange(m)
        k = j % ns
        a = v.reshape(r, m, -1).clone()
        if ns > 1:
            a[1:] *= tw[off:off + (r - 1) * ns].reshape(r - 1, ns)[:, k][..., None]
        q = np.arange(r)
        dft = torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(q, q) / r)
                               .astype(np.complex64))
        y = torch.einsum("qr,rjb->qjb", dft, a)
        out = torch.empty_like(v)
        for qq in range(r):
            out[(j - k) * r + k + qq * ns] = y[qq]
        v = out
        off += (r - 1) * ns
        ns *= r
    assert off == len(tw)
    return v


def _emulate_gap(xr, xi, sign, scale):
    """The GAP instance's decomposition on (B, z, Y, x) planes, every word
    read and written through the kernel's addresses."""
    shape = tuple(xr.shape)
    b, z, y, x = shape
    nq = b * y
    c_ = sk.fused2_cluster(z, x, nq)
    w, h = x // c_, z // c_
    flat = torch.complex(xr.float(), xi.float()).reshape(-1)
    qs = np.arange(nq)
    # 1. each CTA's stripe from device memory, transformed along z in f32
    stripes = flat[torch.from_numpy(_stripe_reads(shape, c_, qs))]
    cols = _stages(stripes.permute(2, 0, 1, 3).reshape(z, -1), z, sign)
    cols = cols.reshape(z, nq, c_, w).permute(1, 2, 0, 3)   # (Q, C, z, w)
    # 3. row r = c*h + t, element i from CTA i // w at column i % w
    i = torch.arange(x)
    rows = cols[:, (i // w)[None, :], torch.arange(z)[:, None],
                (i % w)[None, :]]                           # (Q, z, x)
    rows = _stages(rows.permute(2, 0, 1).reshape(x, -1), x, sign)
    rows = rows.reshape(x, nq, c_, h).permute(1, 2, 3, 0).reshape(nq, c_, -1)
    # 4. the last stage's stores: X = t*x + i of CTA c's rows
    xs = _last_stage_x(x, h)
    addr = torch.from_numpy(_row_writes(shape, c_, qs, xs)).reshape(-1)
    assert torch.equal(torch.bincount(addr, minlength=flat.numel()),
                       torch.ones(flat.numel(), dtype=torch.int64))
    out = torch.empty_like(flat)
    out[addr] = rows[:, :, torch.from_numpy(xs)].reshape(-1) * scale
    out = out.reshape(shape)
    return out.real.to(xr.dtype), out.imag.to(xr.dtype)


CASES = [(2, 32, 3, 256), (1, 160, 2, 128), (3, 16, 2, 384),
         (1, 16, 2, 16384)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("shape", CASES)
def test_gap_cluster_emulation_matches_plain_and_jax(shape, sign, dtype):
    rng = np.random.default_rng(sum(shape))
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = rng.standard_normal(shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    tr = torch.from_numpy(xr).to(tdt)
    ti = torch.from_numpy(xi).to(tdt)
    n = shape[1] * shape[3]
    scale = 1.0 / np.sqrt(n)
    er, ei = _emulate_gap(tr, ti, sign, scale)
    assert er.dtype == ei.dtype == tdt and tuple(er.shape) == shape
    emu = er.double().numpy() + 1j * ei.double().numpy()
    tol = tolerance(n, "complex32" if dtype == "bfloat16" else "complex64")
    pr, pi = sk.fft_axes_gap_plain(tr, ti, sign, scale)
    assert rel_l2(emu, pr.double().numpy() + 1j * pi.double().numpy()) <= tol
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    ref = (np.fft.fftn(xd, axes=(1, 3)) if sign < 0
           else np.fft.ifftn(xd, axes=(1, 3), norm="forward")) * scale
    assert rel_l2(emu, ref) <= tol
    if n > 65536:                       # the JAX runner at 16 x 16384 is slow
        return
    jr, ji = jps.fft_axes_gap_stockham(
        jnp.asarray(tr.float().numpy(), getattr(jnp, dtype)),
        jnp.asarray(ti.float().numpy(), getattr(jnp, dtype)),
        JDirection(sign), scale=scale, interpret=True)
    yj = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
    assert rel_l2(emu, yj) <= tol


# --- the host's choices -------------------------------------------------------
def test_admitted_pairs():
    """The gap gate is the fused2 gate: the same 113 pairs."""
    assert len(PAIRS) == 113
    assert all(sk.fused2_supported(a, b) for a, b in PAIRS)


@pytest.mark.parametrize("b,y", [(1, 2), (2, 3), (1, 512), (4, 256),
                                 (64, 1024)])
def test_cluster_pick_every_admitted_pair(b, y):
    """C over the b*y planes divides z, 8*C divides x (16-byte stripe
    loads), a CTA holds at most FUSED2_CTA_ELEMS elements, its shared
    memory fits the 232,448 B a block can use, and the grid of b*y*C CTAs
    and the row distance y*x stay in an int, as the C entry checks."""
    for z, x in PAIRS:
        c = sk.fused2_cluster(z, x, b * y)
        assert 1 <= c <= sk.FUSED2_MAX_CLUSTER and c & (c - 1) == 0
        assert z % c == 0 and x % (8 * c) == 0, (z, x, c)
        assert z * x // c <= sk.FUSED2_CTA_ELEMS
        assert sk.fused2_smem_bytes(z, x, c) <= sk.SMEM_PER_CTA == 232448
        assert b * y * c <= INT_MAX and y * x <= INT_MAX


# --- every word once ----------------------------------------------------------
def test_row_index_multiply_high_is_exact():
    """t = (X * mag) >> 32 with mag = ceil(2^32 / x) is X // x for every X
    a CTA stores (X < FUSED2_CTA_ELEMS) at every admitted x."""
    xs = np.arange(sk.FUSED2_CTA_ELEMS, dtype=np.int64)
    for x in sorted({p[1] for p in PAIRS}):
        mag = 0xFFFFFFFF // x + 1
        assert mag < 2 ** 32
        assert np.array_equal((xs * mag) >> 32, xs // x), x


@pytest.mark.parametrize("shape", [(2, 32, 3, 256), (1, 160, 2, 128),
                                   (3, 16, 2, 384), (2, 512, 2, 512)])
def test_every_word_once_small(shape):
    """Over the whole tensor: every input word is loaded once, every
    output word stored once, and the last stage stores each X of a CTA's
    rows once."""
    b, z, y, x = shape
    c = sk.fused2_cluster(z, x, b * y)
    qs = np.arange(b * y)
    xs = _last_stage_x(x, z // c)
    assert np.array_equal(np.sort(xs), np.arange(z // c * x))
    want = np.arange(b * z * y * x)
    assert np.array_equal(np.sort(_stripe_reads(shape, c, qs).ravel()), want)
    assert np.array_equal(np.sort(_row_writes(shape, c, qs, xs).ravel()),
                          want)


@pytest.mark.parametrize("shape", [
    (1 << 20, 16, 2, 128),      # 2^32 elements: the last batch past 2^31
    (1, 16, 1 << 21, 128),      # rows 2^28 apart, the last plane past 2^31
    (2, 256, 1 << 14, 1024),    # the second batch starts at 2^32
    (4, 512, 4096, 512)])       # 512^2 planes, 2^32 elements
def test_every_word_once_past_2_31(shape):
    """Offsets beyond 2^31, in Python integers with nothing allocated: the
    first, second, middle and last planes read and write exactly the words
    of their (b, y) plane, the host's int checks hold, and the kernel forms
    every offset that can pass 2^31 in 64 bits."""
    b, z, y, x = shape
    nq = b * y
    c = sk.fused2_cluster(z, x, nq)
    assert nq * c <= INT_MAX and y * x <= INT_MAX
    qs = sorted({0, 1, nq // 2, nq - 2, nq - 1})
    want = np.sort(_mixed_radix(shape, qs))
    assert want[-1] == b * z * y * x - 1 and want[-1] > INT_MAX
    xs = _last_stage_x(x, z // c)
    assert np.array_equal(np.sort(_stripe_reads(shape, c, qs).ravel()), want)
    assert np.array_equal(np.sort(_row_writes(shape, c, qs, xs).ravel()),
                          want)
    src = SRC.read_text()
    for expr in ("plane = (size_t)b * n1 * ld + (size_t)(q - b * Y) * n2",
                 "const size_t o = (size_t)j * ld + 4 * (g - j * wq)",
                 "yr + plane + (size_t)c * h * ld",
                 "o += (size_t)__umulhi((unsigned)x, mag) * skip",
                 "(long long)Y * n2 > 0x7fffffffLL",
                 "P * Y * C > 0x7fffffffLL"):
        assert expr in src, expr


# --- the C entries and the wrapper ---------------------------------------------
def _c_params(name):
    m = re.search(rf"\nint {name}\(([^)]*)\)", SRC.read_text())
    return [p.strip() for p in m.group(1).split(",")]


def test_bf16_entry_takes_no_scratch():
    """fft_gap_bf16 takes fft_gap's arguments: no f32 scratch pointers,
    the cluster size after the shape."""
    sig = _build._SIGNATURES
    assert sig["fft_gap_bf16"] == sig["fft_gap"]
    assert not hasattr(sk, "_mid_planes")
    for name in ("fft_gap", "fft_gap_bf16", "fft_fused2_clusters"):
        params = _c_params(name)
        assert len(params) == len(sig[name]), name
    assert [p.split()[-1] for p in _c_params("fft_gap")[4:9]] == \
        ["B", "z", "Y", "x", "C"]
    assert "float*" not in " ".join(_c_params("fft_gap_bf16"))


def test_wrapper_cpu_planes_run_the_plain_version():
    """CPU planes never reach the cluster kernel: the wrapper runs the plain
    version and counts no launch."""
    rng = np.random.default_rng(5)
    xr = torch.from_numpy(rng.standard_normal((2, 32, 3, 256))
                          .astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((2, 32, 3, 256))
                          .astype(np.float32))
    before = dict(sk.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        yr, yi = sk.fft_axes_gap(xr.to(dt), xi.to(dt), 1, 0.5)
        pr, pi = sk.fft_axes_gap_plain(xr.to(dt), xi.to(dt), 1, 0.5)
        assert torch.equal(yr, pr) and torch.equal(yi, pi)
    assert sk.LAUNCHES == before


def test_gap_plans_prefetch_the_cluster_tables(monkeypatch):
    """A gap-fused plan fetches fused2_stages tables for its two axes (the
    cluster kernel's), the mid axis fft_cols's (cols_stages)."""
    monkeypatch.setenv("REGENT_FFT_GAP_FUSED", "1")
    rt.clear_plan_cache()
    try:
        p = rt.make_plan((2, 16, 8, 256), axes=(1, 2, 3), backend="stockham",
                         device="cpu")
        assert p.steps[0][0] == "stockham_gap"
        got = [(n, f.__name__)
               for n, f in tplan._kernel_lengths(p.steps, p.real, 4)]
        assert got == [(16, "fused2_stages"), (256, "fused2_stages"),
                       (8, "cols_stages")]
    finally:
        rt.clear_plan_cache()
