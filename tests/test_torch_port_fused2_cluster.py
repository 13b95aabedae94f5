"""The cluster design of the ``fft_fused2`` kernels (csrc/stockham.cu,
``fft_fused2_regs_kernel`` and ``fft_fused2_kernel``) emulated on the CPU.

Both run an (n1, n2) plane on a thread-block cluster of C CTAs: CTA c takes
the columns [c*w, (c+1)*w) (w = n2/C) along n1, then the rows [c*h, (c+1)*h)
(h = n1/C) along n2, each axis with its stage list and that list's
float64-generated twiddle table.  At the geometries of ``FUSED2_REGS``
(csrc/fused2.cuh, ``with_f2_geo``) the register body runs, on the lists of
:func:`fused2_regs_stages`: persistent clusters walk the planes round
robin, each CTA's stripe goes through the column recursion (``cols.cuh``'s
with one buffer) from device memory to registers,
its last stage stores element (j, i) into row j % h of CTA j // h's row
buffer (one exchange of the plane, distributed shared memory), and the row
pass runs the same recursion on the rows, lanes along the row, the last
stage to device memory with the scale.  Everywhere else the stage walk
runs on the lists of :func:`fused2_stages`: the stripe in shared memory,
the rows gathered after a cluster barrier.  The emulations follow the kernels' index schemes word by word
(every shared word written once before it is read, every output written
once, the round robin's planes and L2 prefetches), count the bank
conflicts of the register body's layouts, and are held against
``fft_fused2_plain`` and the JAX ``_runner_fused2`` in interpret mode within
``tolerance(n1 * n2, dtype)``, in f32 and bf16, both signs.  The
host-side choices (the cluster size C, each body's shared memory, the
stage lists, the register body's table against the C source) are checked
over every pair ``fused2_supported`` admits.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps

from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils import trace
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

FUSED2_CUH = (Path(sk.__file__).resolve().parent.parent / "csrc"
              / "fused2.cuh")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small tensor operations: one intra-op thread
    each keeps them from fighting the suite's other workers for the cores
    (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

MAX_N = sk.MAX_FUSED2_ELEMS // 16          # n2 <= 16384 since n1 >= 16
FIRST = [n for n in range(16, MAX_N + 1) if sk._fusable_len(n, False)]
LAST = [n for n in range(128, MAX_N + 1) if sk._fusable_len(n, True)]
PAIRS = [(a, b) for a in FIRST for b in LAST if sk.fused2_supported(a, b)]


def test_admitted_pairs_cover_the_gate():
    """Every pair the gate admits is in PAIRS (it caps n1 * n2, so no
    axis passes MAX_N), and it matches the JAX gate."""
    assert len(PAIRS) == 113
    for n1 in range(1, 2049):
        for n2 in (16, 128, 384, 512, 640, 4096, 14336, 16384, 32768):
            got = sk.fused2_supported(n1, n2)
            assert got == jps.fused2_supported(n1, n2), (n1, n2)
            assert got == ((n1, n2) in PAIRS), (n1, n2)


@pytest.mark.parametrize("planes", [1, 3, 16, 132, 512, 4096])
def test_cluster_picker_every_admitted_pair(planes):
    """C is a power of two <= 16 that divides n1 and n2, a CTA holds at
    most FUSED2_CTA_ELEMS elements (32 a thread), and its shared memory
    fits the 227 KB (232,448 B) a block can use."""
    for n1, n2 in PAIRS:
        c = sk.fused2_cluster(n1, n2, planes)
        assert 1 <= c <= sk.FUSED2_MAX_CLUSTER and c & (c - 1) == 0
        assert n1 % c == 0 and n2 % (8 * c) == 0, (n1, n2, c)
        assert n1 * n2 // c <= sk.FUSED2_CTA_ELEMS
        assert n1 * n2 // c <= sk.FUSED2_THREADS * 32
        smem = sk.fused2_cta_smem(n1, n2, c)
        assert smem <= sk.SMEM_PER_CTA == 232448, (n1, n2, c, smem)
        hn = n1 * n2 // c
        if sk.fused2_regs_geometry(n1, n2, c) is not None:
            # the register body: one f32 buffer of h padded rows, which
            # also holds the column exchange
            assert smem == 8 * (n1 // c) * (n2 + n2 // 32) >= 8 * hn
        else:
            # the stage walk: the rows start half a stripe up and end past
            # the stripe
            assert smem == sk.fused2_smem_bytes(n1, n2, c)
            assert smem == 8 * (hn // 2 + hn + hn // 32)
            assert hn // 2 + (hn // 2 + hn // 64) >= hn   # upper half past
        # the least C that fits, raised no higher than 8 to spread a batch
        need = 1 << (-(-n1 * n2 // sk.FUSED2_CTA_ELEMS) - 1).bit_length()
        assert c == need or (c <= 8 and planes * (c // 2) < 132)
    assert sk.fused2_cluster(512, 512, 512) == 16
    assert sk.fused2_cluster(256, 256, 1024) == 4
    assert sk.fused2_cluster(256, 256, 16) == 8


@pytest.mark.parametrize("n", sorted(set(FIRST + LAST)))
def test_fused2_stage_list(n):
    """Radices 8/4 (2 only for n = 2), the odd factor last, Ns a power of
    two at every stage, ceil(log2 / 3) power-of-two stages, and the table
    one entry per (r, k) of every stage."""
    rad = sk.fused2_stages(n)
    assert int(np.prod(rad)) == n
    assert set(rad) <= {3, 4, 5, 7, 8}
    ns = 1
    for r in rad:
        assert ns & (ns - 1) == 0
        ns *= r
    pow2 = [r for r in rad if r & (r - 1) == 0]
    k = int(np.log2(np.prod(pow2)))
    assert len(pow2) == -(-k // 3)
    assert len(rad) >= 2 or n < 128         # the row pass has >= 2 stages
    assert len(rad) <= 12                   # MAX_STAGES of the tile
    tab = sk._stage_tables(rad, -1)
    assert tab.shape == (sum((r - 1) * s for r, s in
                             zip(rad, np.cumprod((1,) + rad[:-1]))), 2)


def _stages(x, n, sign):
    """The kernel's Stockham stages (fused2_stages) along axis 0 of (n, B)
    complex64 columns: stage (R, Ns) reads x[j + r*m], twiddles by table
    entry (r-1)*Ns + j%Ns, runs an R-point DFT and writes
    out[(j - j%Ns)*R + j%Ns + q*Ns]."""
    rad = sk.fused2_stages(n)
    tab = torch.from_numpy(sk._stage_tables(rad, sign))
    tw = torch.complex(tab[:, 0], tab[:, 1])
    ns, off = 1, 0
    for r in rad:
        m = n // r
        j = torch.arange(m)
        k = j % ns
        v = x.reshape(r, m, -1).clone()
        if ns > 1:
            v[1:] *= tw[off:off + (r - 1) * ns].reshape(r - 1, ns)[:, k][..., None]
        q = np.arange(r)
        dft = torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(q, q) / r)
                               .astype(np.complex64))
        y = torch.einsum("qr,rjb->qjb", dft, v)
        out = torch.empty_like(x)
        for qq in range(r):
            out[(j - k) * r + k + qq * ns] = y[qq]
        x = out
        off += (r - 1) * ns
        ns *= r
    assert off == len(tw)
    return x


def _emulate_stage_walk(xr, xi, sign, scale, c):
    """fft_fused2_kernel's decomposition on (P, n1, n2) planes, clusters of
    c CTAs."""
    p, n1, n2 = xr.shape
    w, h = n2 // c, n1 // c
    x = torch.complex(xr.float(), xi.float())
    # 1. CTA k's stripe: columns [k*w, (k+1)*w) along n1, kept in f32
    stripes = torch.stack([
        _stages(x[:, :, k * w:(k + 1) * w].permute(1, 0, 2).reshape(n1, -1),
                n1, sign).reshape(n1, p, w).permute(1, 0, 2)
        for k in range(c)])                               # (C, P, n1, w)
    # 3. CTA k's rows [k*h, (k+1)*h): element j from CTA j // w, column j % w
    # (every CTA's rows at once)
    j = torch.arange(n2)
    seg, col = j // w, j % w
    gathered = stripes[seg, :, :, col]                    # (n2, P, n1)
    y = _stages(gathered.reshape(n2, -1), n2, sign).reshape(n2, p, n1)
    y = y.permute(1, 2, 0) * scale
    return y.real.to(xr.dtype), y.imag.to(xr.dtype)


def _cols_at(x, col, w):
    """The column exchange's layout (fused2.cuh, F2ColGeo::at): element x
    of column col of a stripe w >= 32 columns wide."""
    assert w >= 32
    return x * w + col


def _rows_at(x, row, n, tpc):
    """The row buffer's layout (fused2.cuh, F2RowGeo::at): element x of row
    `row` of n points, one pad word every 32 (tpc, the threads a row, does
    not enter it: the pitch n + n/32 puts a warp's rows 32/RW banks
    apart)."""
    del tpc
    return row * (n + n // 32) + x + (x >> 5)


def _dft(v, r, sign):
    """R-point DFTs along the last axis of complex64 v."""
    k = np.arange(r)
    mat = torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(k, k) / r)
                           .astype(np.complex64))
    return torch.einsum("kr,...r->...k", mat, v)


NAN = complex(float("nan"), float("nan"))


def _recursion(n, tpc, lane, line, at, load, store, sign):
    """fused2.cuh's f2_regs_stage over fused2_regs_stages(n) for every
    thread of every CTA at once: thread (line, lane) takes butterflies
    j = lane + b*tpc of each stage (whole butterflies: nb * tpc == m),
    stage 0 reads ``load(idx)`` ((CTA, thread, b, r) complex64), later
    stages the CTA's one exchange buffer in layout ``at(x, line)``, the last
    stage hands output element j + r*Ns to ``store(k, keep, v)``."""
    rad = sk.fused2_regs_stages(n)
    tab = sk._stage_tables(rad, sign)
    tw = torch.complex(torch.from_numpy(tab[:, 0]), torch.from_numpy(tab[:, 1]))
    ns, off, buf = 1, 0, None
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpc)
        assert nb * tpc == m, "whole butterflies a thread"
        jraw = lane[:, None] + torch.arange(nb) * tpc          # (thr, nb)
        j = jraw.clamp(max=m - 1)
        keep = jraw < m
        idx = j[..., None] + torch.arange(r) * m               # (thr, nb, r)
        if st == 0:
            v = load(idx)
        else:
            v = buf[:, at(idx, line[:, None, None])]
            assert not torch.isnan(v.real).any(), "read of an unwritten word"
        k = j % ns
        if ns > 1:
            w = tw[off + (torch.arange(1, r) - 1) * ns + k[..., None]]
            v = torch.cat([v[..., :1], v[..., 1:] * w], -1)
        v = _dft(v, r, sign)
        if st == len(rad) - 1:
            assert ns * r == n
            store(j[..., None] + torch.arange(r) * ns,
                  keep[..., None].expand(idx.shape), v)
        else:
            base = (j - k) * r + k
            a = at(base[..., None] + torch.arange(r) * ns, line[:, None, None])
            sel = keep[..., None].expand(a.shape)
            words = a[sel]
            assert sorted(words.tolist()) == sorted(set(words.tolist()))
            if buf is None:
                buf = torch.full((v.shape[0], int(words.max()) + 1), NAN,
                                 dtype=torch.complex64)
            assert int(words.max()) < buf.shape[1], "exchange layout"
            buf.fill_(NAN)
            buf[:, words] = v[:, sel]
        off += (r - 1) * ns
        ns *= r
    assert off == len(tw)


def _round_robin(p, clusters):
    """The persistent grid's schedule: cluster q takes planes q, q + Q, ...
    (Q = clusters).  Returns [(cluster, plane)]."""
    return [(q0, q) for q0 in range(clusters) for q in range(q0, p, clusters)]


def _emulate_regs(xr, xi, sign, scale, c, clusters, interleaved=False):
    """fft_fused2_regs_kernel on (P, n1, n2) planes, clusters of c CTAs, a
    persistent grid of ``clusters`` clusters; with ``interleaved`` its IL
    instance (F2ColIlIO), which reads the planes' values from one complex64
    tensor, element (j, i) of a plane the (re, im) word pair at pair
    j*n2 + i."""
    p, n1, n2 = xr.shape
    g = sk.fused2_regs_geometry(n1, n2, c)
    w, h, nt = g["w"], g["h"], g["threads"]
    tpc1, tpc2 = g["tpc_cols"], g["tpc_rows"]
    part = h * g["pitch"]
    assert tpc1 * w == nt == tpc2 * h and g["smem_bytes"] == 8 * part
    assert part >= n1 * w                  # the column exchange fits
    t = torch.arange(nt)
    col, lane1 = t % w, t // w
    row, lane2 = t // tpc2, t % tpc2
    cta = torch.arange(c)
    x = torch.complex(xr.float(), xi.float()).reshape(-1)
    xw = torch.view_as_real(x).reshape(-1)   # the interleaved tensor
    y = torch.full((p * n1 * n2,), NAN, dtype=torch.complex64)
    written = torch.zeros(p * n1 * n2, dtype=torch.int32)
    plane_words = n1 * n2
    seen = []
    for _, q in _round_robin(p, clusters):
        seen.append(q)
        lo = q * plane_words
        rowbuf = torch.full((c, part), NAN, dtype=torch.complex64)
        rowhits = torch.zeros((c, part), dtype=torch.int32)

        def load_cols(idx):          # (thr, nb, r) rows of the stripe
            flat = (lo + idx[None] * n2
                    + (cta[:, None] * w + col)[:, :, None, None])
            assert bool(((flat >= lo) & (flat < lo + plane_words)).all())
            if not interleaved:
                return x[flat]
            # one 8-byte load a value: words 2*flat and 2*flat + 1, 8-byte
            # aligned; the 32 lanes of a warp read 32 consecutive pairs, 256
            # contiguous bytes
            lanes = flat.reshape(c, nt // 32, 32, *flat.shape[2:])
            step = (lanes - lanes[:, :, :1]).movedim(2, -1)
            assert bool((step == torch.arange(32)).all()), "warp runs"
            byte = 8 * flat
            assert bool((byte % 8 == 0).all())
            return torch.complex(xw[byte // 4], xw[byte // 4 + 1])

        def scatter(k, keep, v):     # element (k, i) -> CTA k // h, row k % h
            i = (cta[:, None] * w + col)[:, :, None, None].expand(v.shape)
            kk = k[None].expand(v.shape)
            dest, r_ = kk // h, kk % h
            word = _rows_at(i, r_, n2, tpc2)
            sel = keep[None].expand(v.shape)
            rowbuf[dest[sel], word[sel]] = v[sel]
            rowhits.index_put_((dest[sel], word[sel]),
                               torch.ones_like(word[sel], dtype=torch.int32),
                               accumulate=True)

        _recursion(n1, tpc1, lane1, col, lambda a, b: _cols_at(a, b, w),
                   load_cols, scatter, sign)
        # the cluster barrier: every word of every row written exactly once
        # (the pad words never)
        words = _rows_at(torch.arange(n2)[None], torch.arange(h)[:, None],
                         n2, tpc2).reshape(-1)
        assert bool((rowhits[:, words] == 1).all()), "the exchange's map"
        assert int(rowhits.sum()) == c * n1 * w

        def load_rows(idx):
            return rowbuf[:, _rows_at(idx, row[:, None, None], n2, tpc2)]

        def store_rows(k, keep, v):
            flat = (lo + ((cta[:, None] * h + row) * n2)[:, :, None, None]
                    + k[None]).expand(v.shape)
            sel = keep[None].expand(v.shape)
            y[flat[sel]] = v[sel] * scale
            written.index_put_((flat[sel],),
                               torch.ones_like(flat[sel], dtype=torch.int32),
                               accumulate=True)

        at2 = lambda a, b: _rows_at(a, b, n2, tpc2)   # noqa: E731
        _recursion(n2, tpc2, lane2, row, at2, load_rows, store_rows, sign)
    assert sorted(seen) == list(range(p)), "the round robin's planes"
    assert bool((written == 1).all()), "every output written once"
    y = y.reshape(p, n1, n2)
    return y.real.to(xr.dtype), y.imag.to(xr.dtype)


def _emulate_cluster(xr, xi, sign, scale, c=None, clusters=8,
                     interleaved=False):
    """What fft_fused2 runs on (P, n1, n2) planes with clusters of c CTAs
    (the host's pick for P planes when None): the register body where it
    has an instance (``interleaved``: its IL instance), the stage walk
    elsewhere."""
    p, n1, n2 = xr.shape
    c = sk.fused2_cluster(n1, n2, p) if c is None else c
    if sk.fused2_regs_geometry(n1, n2, c) is not None:
        return _emulate_regs(xr, xi, sign, scale, c, clusters, interleaved)
    assert not interleaved, "the stage walk has no interleaved instance"
    return _emulate_stage_walk(xr, xi, sign, scale, c)


CASES = [(2, 32, 256), (1, 160, 128), (3, 16, 384), (1, 16, 16384)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("shape", CASES)
def test_cluster_emulation_matches_plain_and_jax(shape, sign, dtype):
    rng = np.random.default_rng(sum(shape))
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = rng.standard_normal(shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    tr = torch.from_numpy(xr).to(tdt)
    ti = torch.from_numpy(xi).to(tdt)
    n = shape[1] * shape[2]
    scale = 1.0 / np.sqrt(n)
    er, ei = _emulate_cluster(tr, ti, sign, scale)
    assert er.dtype == ei.dtype == tdt and tuple(er.shape) == shape
    emu = er.double().numpy() + 1j * ei.double().numpy()
    tol = tolerance(n, "complex32" if dtype == "bfloat16" else "complex64")
    pr, pi = sk.fft_fused2_plain(tr, ti, sign, scale)
    assert rel_l2(emu, pr.double().numpy() + 1j * pi.double().numpy()) <= tol
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    ref = (np.fft.fftn(xd, axes=(1, 2)) if sign < 0
           else np.fft.ifftn(xd, axes=(1, 2), norm="forward")) * scale
    assert rel_l2(emu, ref) <= tol
    if n > 65536:                        # the JAX runner at 16 x 16384 is slow
        return
    jr, ji = jps.fft_axes2_stockham(
        jnp.asarray(xr, getattr(jnp, dtype)), jnp.asarray(xi, getattr(jnp, dtype)),
        JDirection(sign), scale=scale, interpret=True)
    yj = (np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64))
    assert rel_l2(emu, yj) <= tol


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    xr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return xr.to(dtype), xi.to(dtype)


def _check(er, ei, tr, ti, sign, scale, dtype):
    """The emulation's output against the plain version and numpy."""
    n = tr.shape[1] * tr.shape[2]
    assert er.dtype == ei.dtype == tr.dtype and er.shape == tr.shape
    emu = er.double().numpy() + 1j * ei.double().numpy()
    tol = tolerance(n, "complex32" if dtype == torch.bfloat16 else "complex64")
    pr, pi = sk.fft_fused2_plain(tr, ti, sign, scale)
    assert rel_l2(emu, pr.double().numpy() + 1j * pi.double().numpy()) <= tol
    xd = tr.double().numpy() + 1j * ti.double().numpy()
    ref = (np.fft.fftn(xd, axes=(1, 2)) if sign < 0
           else np.fft.ifftn(xd, axes=(1, 2), norm="forward")) * scale
    assert rel_l2(emu, ref) <= tol
    return emu, tol


def test_regs_table_matches_the_c_source():
    """csrc/fused2.cuh's with_f2_geo and FUSED2_REGS name the same
    instances; each runs fused2_regs_stages' lists, E values a thread on
    both axes in whole butterflies of every radix, 512 threads at most (128
    registers each, one CTA an SM), a stripe fft_cols' layout takes (w a
    power of two, the 16-byte rows of 32 columns), rows of whole 32-word
    groups, one f32 buffer within the 227 KB; the host's cluster pick
    reaches it for a batch that fills the card."""
    text = FUSED2_CUH.read_text()
    named = {m.group(1): (int(m.group(2)),
                          tuple(int(v) for v in m.group(3).split(",")))
             for m in re.finditer(
                 r"using (L\d+) = LastList<(\d+), ([\d, ]+)>;", text)}
    got = {}
    for m in re.finditer(
            r"if \(n1 == (\d+) && n2 == (\d+) && C == (\d+)\) return "
            r"f\(F2Geo<(\d+), (\d+), (L\d+), (L\d+)>\{\}\);", text):
        n1, n2, c, c2, e = (int(m.group(i)) for i in range(1, 6))
        assert c == c2
        for n, lname in ((n1, m.group(6)), (n2, m.group(7))):
            assert named[lname] == (n, sk.fused2_regs_stages(n)), lname
        got[(n1, n2, c)] = e
    assert got == sk.FUSED2_REGS
    for (n1, n2, c), e in got.items():
        g = sk.fused2_regs_geometry(n1, n2, c)
        assert sk.fused2_supported(n1, n2)
        assert n1 % e == 0 and n2 % e == 0 and n1 % c == 0 and n2 % c == 0
        for n in (n1, n2):
            assert all(e % r == 0 for r in sk.fused2_regs_stages(n))
            assert len(sk.fused2_regs_stages(n)) == 2    # one exchange
        assert g["threads"] == n1 * (n2 // c) // e <= sk.FUSED2_THREADS
        assert g["w"] >= 32 and g["w"] & (g["w"] - 1) == 0
        assert n2 % 32 == 0
        assert g["smem_bytes"] <= sk.SMEM_PER_CTA
        assert sk.fused2_cluster(n1, n2, 4096) == c
    assert sk.fused2_regs_geometry(256, 256, 8) is None
    assert sk.fused2_regs_geometry(128, 1024, 8) is None


def _banks(addrs):
    """The worst count of distinct words one bank serves in each warp-wide
    access (rows of 32 word addresses, 32 banks of 4-byte words)."""
    worst = 1
    for a in addrs.reshape(-1, 32).tolist():
        per = {}
        for w in a:
            per.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(v) for v in per.values()))
    return worst


@pytest.mark.parametrize("geo", sorted(sk.FUSED2_REGS))
def test_regs_layouts_free_of_bank_conflicts(geo):
    """Every warp-wide shared access of the register body hits distinct
    banks: the column exchange (fft_cols' layout), the column pass's stores
    into a row buffer (32 consecutive columns of one row a warp, each CTA's
    share), and the row pass's reads and stride-R writes in F2RowGeo's
    layout."""
    n1, n2, c = geo
    g = sk.fused2_regs_geometry(n1, n2, c)
    w, h = g["w"], g["h"]
    t = torch.arange(g["threads"])
    for n, tpc, lane, line, at in (
            (n1, g["tpc_cols"], t // w, t % w,
             lambda x, ln: _cols_at(x, ln, w)),
            (n2, g["tpc_rows"], t % g["tpc_rows"], t // g["tpc_rows"],
             lambda x, ln: _rows_at(x, ln, n2, g["tpc_rows"]))):
        ns = 1
        rad = sk.fused2_regs_stages(n)
        for st, r in enumerate(rad):
            m = n // r
            for b in range(m // tpc):
                j = lane + b * tpc
                k = j % ns
                for q in range(r):
                    assert _banks(at(j + q * m, line)) == 1, (n, st, "read")
                    if st < len(rad) - 1:
                        a = at((j - k) * r + k + q * ns, line)
                        assert _banks(a) == 1, (n, st, "write")
            ns *= r
    # the column pass's stores: warp (32 columns, one lane) -> one row
    col = t % w
    for dest_row in range(h):
        for c0 in range(c):
            i = c0 * w + col
            a = _rows_at(i, torch.full_like(i, dest_row), n2, g["tpc_rows"])
            assert _banks(a) == 1


@pytest.mark.parametrize("clusters", [7, 8, 33])
def test_round_robin_every_plane_once(clusters):
    """The persistent grid at 1, clusters - 1, clusters + 1 and 512
    planes (a grid of min(P, clusters) clusters): every plane taken once,
    by cluster q % Q, in ascending order within a cluster; the last wave
    ragged (the first P % Q clusters take one plane more)."""
    for p in (1, clusters - 1, clusters + 1, 512):
        q_ = min(p, clusters)
        sched = _round_robin(p, q_)
        assert sorted(q for _, q in sched) == list(range(p))
        last = {}
        for q0, q in sched:
            assert q % q_ == q0 and last.get(q0, -1) < q
            last[q0] = q
        per = [sum(1 for c_, _ in sched if c_ == q0) for q0 in range(q_)]
        assert per == [p // q_ + (q0 < p % q_) for q0 in range(q_)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("p_clusters", [(1, 1), (2, 3), (4, 3), (7, 3)])
def test_regs_emulation_ragged_planes(p_clusters, sign, dtype):
    """The register body at 256^2 (C = 4) on a persistent grid with fewer,
    as many and more planes than clusters, against the plain version and
    numpy; the JAX runner at one count."""
    p, clusters = p_clusters
    tdt = getattr(torch, dtype)
    tr, ti = _planes((p, 256, 256), tdt, p * 31 + clusters)
    er, ei = _emulate_cluster(tr, ti, sign, 0.25, c=4, clusters=clusters)
    emu, tol = _check(er, ei, tr, ti, sign, 0.25, tdt)
    if p_clusters != (2, 3):
        return
    jr, ji = jps.fft_axes2_stockham(
        jnp.asarray(tr.float().numpy(), getattr(jnp, dtype)),
        jnp.asarray(ti.float().numpy(), getattr(jnp, dtype)),
        JDirection(sign), scale=0.25, interpret=True)
    yj = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
    assert rel_l2(emu, yj) <= tol


@pytest.mark.parametrize("sign", [-1, 1])
def test_regs_emulation_512(sign):
    """The register body at the main path's 512^2 (C = 16): two planes on
    one cluster (one prefetch), f32, against the plain version and numpy."""
    tr, ti = _planes((2, 512, 512), torch.float32, 7 + sign)
    er, ei = _emulate_cluster(tr, ti, sign, 1.0 / 512, c=16, clusters=1)
    _check(er, ei, tr, ti, sign, 1.0 / 512, torch.float32)


@pytest.mark.parametrize("case", [(256, 3, 2, -1), (256, 3, 2, 1),
                                  (256, 1, 1, 1), (512, 2, 1, -1)])
def test_regs_emulation_interleaved_input(case):
    """The register body's interleaved-input instance
    (fft_fused2_interleaved_in) at both geometries, a ragged round robin at
    256^2: every load an aligned 8-byte (re, im) pair, a warp's 32 columns
    256 contiguous bytes, the values the planar load reads, so the output
    equals the planar instance's bit for bit, and the plain version's and
    numpy's within tolerance."""
    n, p, clusters, sign = case
    c = {256: 4, 512: 16}[n]
    tr, ti = _planes((p, n, n), torch.float32, n + p + sign)
    er, ei = _emulate_cluster(tr, ti, sign, 0.5, c=c, clusters=clusters,
                              interleaved=True)
    pr, pi = _emulate_cluster(tr, ti, sign, 0.5, c=c, clusters=clusters)
    assert torch.equal(er, pr) and torch.equal(ei, pi)
    _check(er, ei, tr, ti, sign, 0.5, torch.float32)


def test_interleaved_input_only_at_the_register_body():
    """fused2_reads_complex: f32 planes at the register body's instances
    (the cluster size a batch picks), nowhere else: bf16 and f64 planes,
    the stage walk's pairs and a batch too small for the register body's
    cluster size read planes."""
    f32 = torch.float32
    assert sk.fused2_reads_complex((512, 512, 512), f32)
    assert sk.fused2_reads_complex((1, 512, 512), f32)
    assert sk.fused2_reads_complex((256, 256, 256), f32)
    assert not sk.fused2_reads_complex((16, 256, 256), f32)   # C = 8
    assert not sk.fused2_reads_complex((512, 512, 512), torch.bfloat16)
    assert not sk.fused2_reads_complex((512, 512, 512), torch.float64)
    for n1, n2 in PAIRS:
        got = sk.fused2_reads_complex((4096, n1, n2), f32)
        assert got == (sk.fused2_regs_geometry(
            n1, n2, sk.fused2_cluster(n1, n2, 4096)) is not None)


@pytest.mark.parametrize("first", FIRST)
def test_dispatched_body_every_admitted_pair(first):
    """At every admitted pair, on one plane with the cluster size a batch
    that fills the card gets (fused2_cluster at 132 planes): the body
    fft_fused2 runs there (the register body at its instances, the stage
    walk elsewhere), emulated, against the plain version and numpy, one
    sign a pair (alternating)."""
    for i, (n1, n2) in enumerate(p_ for p_ in PAIRS if p_[0] == first):
        c = sk.fused2_cluster(n1, n2, 132)
        tr, ti = _planes((1, n1, n2), torch.float32, n1 + n2)
        sign = -1 if i % 2 else 1
        er, ei = _emulate_cluster(tr, ti, sign, 0.5, c=c, clusters=1)
        _check(er, ei, tr, ti, sign, 0.5, torch.float32)


def test_wrapper_counts_register_body_planes(monkeypatch):
    """On the card the wrapper counts the planes the register body takes in
    trace.COUNTS["fused2_planes"] (1024 a 512^3 C2C step: two calls of 512
    planes), none for the stage walk; one launch each.  The launch is
    stubbed: nothing reaches a card."""
    calls = []
    monkeypatch.setattr(sk, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(sk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(sk, "device_tables",
                        lambda n, sign, dev, stages, dtype=None:
                        (torch.zeros(1), None, 0))
    monkeypatch.setattr(sk, "_c2c_entry", lambda name, xr: (name, None))
    monkeypatch.setattr(sk, "_launch",
                        lambda name, fn, dev, *a, nbytes: calls.append(
                            (name, a[5:8], nbytes)))
    trace.reset_counts()
    for shape in ((512, 512, 512), (512, 512, 512), (3, 128, 1024),
                  (1024, 256, 256), (4, 256, 256)):
        x = torch.empty(shape, device="meta")
        sk.fft_fused2(x, x, -1)
    assert [c_[1] for c_ in calls] == [(512, 512, 16), (512, 512, 16),
                                       (128, 1024, 8), (256, 256, 4),
                                       (256, 256, 8)]
    assert trace.COUNTS["fused2_planes"] == 1024 + 1024
    assert [c_[2] for c_ in calls][:2] == [4 * 4 * 512 ** 3] * 2
    trace.reset_counts()


def test_wrapper_interleaved_input_launch(monkeypatch):
    """On the card a complex64 tensor (xi None) launches the interleaved
    entry at the register body's cluster size, counted as fft_fused2 with
    the planar launch's bytes (16 B an element) and its planes in
    trace.COUNTS["fused2_planes"]; f32 planes come back.  Where the
    register body has no instance the wrapper raises.  The launch is
    stubbed: nothing reaches a card."""
    calls = []
    monkeypatch.setattr(sk, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(sk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(sk, "device_tables",
                        lambda n, sign, dev, stages, dtype=None:
                        (torch.zeros(1), None, 0))
    from regent_fft_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "load", lambda: type(
        "Lib", (), {"fft_fused2_interleaved_in": "il"}))
    monkeypatch.setattr(sk, "_launch",
                        lambda name, fn, dev, *a, nbytes: calls.append(
                            (name, fn, a[3:7], nbytes)))
    trace.reset_counts()
    x = torch.empty((512, 512, 512), dtype=torch.complex64, device="meta")
    yr, yi = sk.fft_fused2(x, None, -1)
    assert calls == [("fft_fused2", "il", (512, 512, 512, 16),
                      16 * 512 ** 3)]
    assert yr.dtype == yi.dtype == torch.float32 and yr.shape == x.shape
    assert trace.COUNTS["fused2_planes"] == 512
    with pytest.raises(ValueError, match="no complex64 input"):
        sk.fft_fused2(torch.empty((3, 128, 1024), dtype=torch.complex64,
                                  device="meta"), None, -1)
    trace.reset_counts()


def test_wrapper_cpu_planes_run_the_plain_version():
    """CPU planes never reach the cluster kernel: the wrapper runs the plain
    version and counts no launch."""
    rng = np.random.default_rng(5)
    xr = torch.from_numpy(rng.standard_normal((2, 32, 256)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((2, 32, 256)).astype(np.float32))
    before = dict(sk.LAUNCHES)
    yr, yi = sk.fft_fused2(xr, xi, -1, 0.5)
    assert sk.LAUNCHES == before
    pr, pi = sk.fft_fused2_plain(xr, xi, -1, 0.5)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
