"""The f64 instances of the column kernel (``fft_cols_f64``, csrc/cols.cu)
and the row kernel (``fft_last_f64``, csrc/stockham.cu on csrc/last.cuh)
emulated on the CPU in float64.

They are the f32 bodies with double planes, arithmetic and twiddles, at
tiles of their own: a column of n points is held by n / E threads (E = 16
from n = 16 on) and a block takes C columns (``COLS64_CASE`` in
csrc/cols.cuh); a row of n points is held by n / 16 threads and a block is
at most ``LastTile<double>::BLOCK`` threads (csrc/last.cuh), with one
shared buffer where two would keep ``MINB`` blocks off an SM.  Shared words
are 8 bytes: an access is served a half warp at a time, 16 threads on 16
eight-byte slots of the 32 banks, and the column layout's rows are 16 words
(``ColsGeo::ROW``).

The emulations follow each tile's index scheme in torch in complex128 and
check that every load stays inside its plane, that every exchange writes
each word of the block's buffer once, that every read finds a written word
and that every output element is written once; they count the exchanges'
bank conflicts in 8-byte words; and they are held against numpy at every
f64 instance length, both signs, P in {1, 3} and a ragged V (rows: B = 1
and a ragged last block) within ``tolerance(n, "complex128")``.  The
instance tables are read from the source and held against the stage lists,
and the f64 twiddle tables against numpy's float64 cos/sin bit for bit.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

CSRC = Path(__file__).resolve().parent.parent / "regent_fft_tpu_torch" / "csrc"
SMEM_MAX = 232448
LENGTHS = [1 << k for k in range(1, 11)]
COLS64 = {int(m.group(1)): (int(m.group(2)), int(m.group(3)),
                            tuple(int(v) for v in m.group(4).split(",")))
          for m in re.finditer(r"COLS64_CASE\((\d+), (\d+), (\d+), ([0-9, ]+)\)",
                               (CSRC / "cols.cuh").read_text())}
_LAST = (CSRC / "last.cuh").read_text()
LAST64 = {int(m.group(1)): tuple(int(v) for v in m.group(2).split(","))
          for m in re.finditer(r"LAST64_CASE\((\d+), ([0-9, ]+)\)", _LAST)}
_TILE = re.search(r"struct LastTile<double> \{\s*static constexpr int BLOCK = "
                  r"(\d+);\s*static constexpr int MINB = (\d+);", _LAST)
ROW_BLOCK, ROW_MINB = int(_TILE.group(1)), int(_TILE.group(2))


def test_f64_lengths():
    """Every power of two from 2 to MAX_F64_N has an f64 instance of both
    kernels, and nothing else does."""
    assert [n for n in range(1, 4097) if sk.f64_len_ok(n)] == LENGTHS
    assert sk.MAX_F64_N == 1024


def _cols_geometry(n):
    """ColsGeo<n, E, C, S, double>: E values a thread, C columns and
    TPC * C threads a block, MINB blocks an SM, BUFS shared buffers."""
    e, c, rad = COLS64[n]
    tpc = n // e
    threads = tpc * c
    minb = max(1, 512 // threads)
    buf = 16 * n * c
    s = len(rad)
    bufs = 0 if s < 2 else (2 if s > 2 and 2 * buf * minb <= SMEM_MAX
                            else 1)
    return dict(E=e, C=c, TPC=tpc, THREADS=threads, MINB=minb, BUFS=bufs,
                SMEM=bufs * buf)


def _row_geometry(n):
    """LastGeo<n, 16, double>: TPR threads a row, RPB rows a block, the row
    pitch, BUFS shared buffers and their bytes."""
    rad = LAST64[n]
    tpr = n // rad[0]
    rpb = 1 if tpr >= ROW_BLOCK else ROW_BLOCK // tpr
    pitch = n if n >= 512 else n + n // 16
    buf = 16 * rpb * pitch
    s = len(rad)
    bufs = (0 if s < 2 else 1 if s < 3 or 2 * buf * ROW_MINB > SMEM_MAX
            else 2)
    return dict(TPR=tpr, RPB=rpb, THREADS=tpr * rpb, PITCH=pitch, BUFS=bufs,
                SMEM=bufs * buf)


@pytest.mark.parametrize("kernel", ["cols", "last"])
def test_f64_instance_tables_match_the_stage_lists(kernel):
    """csrc/cols.cuh and csrc/last.cuh compile one f64 instance per length,
    with the stage list of cols_stages / last_stages; a column thread's E
    values are one first-radix butterfly (the whole column up to n = 16),
    every block fits (at most 1024 threads, its shared memory MINB times on
    an SM), column runs along the contiguous axis are 64 B or more and 128
    B up to n = 512, and the row tile keeps a row's 16 values a thread."""
    if kernel == "cols":
        assert set(COLS64) == set(LENGTHS)
        for n in LENGTHS:
            e, c, rad = COLS64[n]
            assert rad == sk.cols_stages(n), n
            assert e == rad[0] == min(n, 16)
            g = _cols_geometry(n)
            assert g["C"] & (g["C"] - 1) == 0 and g["THREADS"] <= 1024
            assert g["SMEM"] * g["MINB"] <= SMEM_MAX, n
            assert 8 * g["C"] >= (128 if n <= 512 else 64), n
    else:
        assert LAST64 == {n: sk.last_stages(n) for n in LENGTHS}
        assert ROW_BLOCK <= 1024 and ROW_MINB >= 1
        for n in LENGTHS:
            g = _row_geometry(n)
            assert g["TPR"] * LAST64[n][0] == n
            assert g["THREADS"] <= max(ROW_BLOCK, g["TPR"])
            assert g["SMEM"] * ROW_MINB <= SMEM_MAX or g["BUFS"] == 1, n


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("rad", sorted({sk.cols_stages(n) for n in LENGTHS}
                                       | {(16, 16, 8), (8, 3), (16, 5)}))
def test_f64_stage_tables_are_numpys_float64_trig(rad, sign):
    """The f64 instances read the float64 twiddles of the stage list as
    numpy makes them, bit for bit (no f32 rounding on the way); the f32
    table is the same table rounded once."""
    got = sk._stage_tables(rad, sign, np.float64)
    assert got.dtype == np.float64 and got.flags.c_contiguous
    want, ns = [], 1
    for r in rad:
        for q in range(1, r):
            for k in range(ns):
                th = (2.0 * np.pi / (ns * r)) * float((q * k) % (ns * r))
                th *= float(sign)
                want.append((np.cos(th), np.sin(th)))
        ns *= r
    assert np.array_equal(got, np.array(want, np.float64))
    assert np.array_equal(sk._stage_tables(rad, sign),
                          got.astype(np.float32))


def _col_at(x, c, cols):
    """Word of element x of column c in a buffer of C = cols columns, rows of
    16 eight-byte words (ColsGeo<..., double>::at)."""
    if cols >= 16:
        return x * cols + c
    g = 16 // cols
    lg = g.bit_length() - 1
    return ((x >> lg) << 4) + ((x ^ (x >> 4)) & (g - 1)) * cols + c


def _row_layout(n):
    """Where word x of a row lies in its part of a buffer (LastGeo::at)."""
    if n >= 512:
        return lambda x: x ^ ((x >> 4) & 31)
    return lambda x: x + (x >> 4)


def _mat(q, sign):
    k = np.arange(q)
    return torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(k, k) / q))


def _dft(v, r, sign):
    """R-point DFTs along the last axis of complex128 v; radix 16 as the
    kernels' Dft<16>: 4-point DFTs over a (r = 4a + b), W16^(b*k1), 4-point
    DFTs over b, k = k1 + 4*k2."""
    if r != 16:
        return torch.einsum("kr,...r->...k", _mat(r, sign), v)
    t = v.reshape(v.shape[:-1] + (4, 4))
    u = torch.einsum("ka,...ab->...kb", _mat(4, sign), t)
    kb = np.outer(np.arange(4), np.arange(4))
    u = u * torch.from_numpy(np.exp(sign * 2j * np.pi * kb / 16))
    y = torch.einsum("...kb,qb->...kq", u, _mat(4, sign))
    return y.transpose(-1, -2).reshape(v.shape)


def _twiddles(rad, sign):
    tab = sk._stage_tables(rad, sign, np.float64)
    return torch.complex(torch.from_numpy(tab[:, 0]),
                         torch.from_numpy(tab[:, 1]))


def _emulate_cols(xr, xi, sign, scale):
    """fft_cols_kernel<double, ...>'s index scheme on (P, n, V) planes,
    every block and thread at once."""
    p_, n, v_ = xr.shape
    rad = sk.cols_stages(n)
    g = _cols_geometry(n)
    cols, tpc = g["C"], g["TPC"]
    tid = torch.arange(g["THREADS"])
    c, lane = tid % cols, tid // cols
    ntiles = -(-v_ // cols)
    blk = torch.arange(p_ * ntiles)
    pre, tile = blk // ntiles, blk % ntiles
    col = tile[:, None] * cols + c
    valid = col < v_
    off = pre[:, None] * n * v_ + torch.where(valid, col,
                                              torch.full_like(col, v_ - 1))
    lo = (pre * n * v_)[:, None, None, None]
    x = torch.complex(xr, xi).reshape(-1)
    nan = complex(float("nan"), float("nan"))
    y = torch.full((p_ * n * v_,), nan, dtype=torch.complex128)
    bufs = [torch.full((len(blk), n * cols), nan, dtype=torch.complex128)
            for _ in range(max(1, g["BUFS"]))]
    tw = _twiddles(rad, sign)
    ns, off_tw = 1, 0
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpc)
        jraw = lane[:, None] + torch.arange(nb) * tpc
        j = jraw.clamp(max=m - 1)
        keep = jraw < m
        idx = j[..., None] + torch.arange(r) * m
        if st == 0:
            assert nb * tpc == m and nb * r == g["E"]
            flat = off[:, :, None, None] + idx[None] * v_
            assert bool(((flat >= lo) & (flat < lo + n * v_)).all()), \
                "load outside its plane"
            v = x[flat]
        else:
            a = _col_at(idx, c[:, None, None], cols)
            v = bufs[(st - 1) % g["BUFS"]][:, a]
            assert not torch.isnan(v.real).any(), "read of an unwritten word"
        k = j % ns
        if ns > 1:
            w = tw[off_tw + (torch.arange(1, r) - 1) * ns + k[..., None]]
            v = torch.cat([v[..., :1], v[..., 1:] * w], -1)
        v = _dft(v, r, sign)
        if st == len(rad) - 1:
            assert ns * r == n
            oidx = j[..., None] + torch.arange(r) * ns
            flat = (off[:, :, None, None] + oidx[None] * v_).expand(v.shape)
            sel = (valid[:, :, None, None] & keep[None, :, :, None]).expand(
                v.shape)
            got = flat[sel]
            assert len(set(got.tolist())) == len(got) == p_ * n * v_
            y[got] = v[sel] * scale
        else:
            base = (j - k) * r + k
            a = _col_at(base[..., None] + torch.arange(r) * ns,
                        c[:, None, None], cols)
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
    return y.real, y.imag


def _emulate_rows(xr, xi, sign, scale):
    """fft_last_kernel<double, ...>'s index scheme on (B, n) planes."""
    b_rows, n = xr.shape
    rad = sk.last_stages(n)
    g = _row_geometry(n)
    tpr, rpb, pitch = g["TPR"], g["RPB"], g["PITCH"]
    at = _row_layout(n)
    words = at(torch.arange(n))
    assert len(set(words.tolist())) == n and int(words.max()) < pitch
    nblk = -(-b_rows // rpb)
    tid = torch.arange(g["THREADS"])
    rl, lane = tid // tpr, tid % tpr
    row = torch.arange(nblk)[:, None] * rpb + rl
    valid = row < b_rows
    src = torch.where(valid, row, torch.full_like(row, b_rows - 1))
    x = torch.complex(xr, xi)
    nan = complex(float("nan"), float("nan"))
    y = torch.full((b_rows, n), nan, dtype=torch.complex128)
    bufs = [torch.full((nblk, rpb * pitch), nan, dtype=torch.complex128)
            for _ in range(max(1, g["BUFS"]))]
    tw = _twiddles(rad, sign)
    every_word = sorted(w_ for r_ in range(rpb)
                        for w_ in (r_ * pitch + words).tolist())
    ns, off = 1, 0
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpr)
        jraw = lane[:, None] + torch.arange(nb) * tpr
        j = jraw.clamp(max=m - 1)
        keep = jraw < m
        idx = j[..., None] + torch.arange(r) * m
        if st == 0:
            assert nb == 1 and bool(keep.all())
            v = x[src[:, :, None, None], idx[None]]
        else:
            v = bufs[(st - 1) % g["BUFS"]][:, rl[:, None, None] * pitch
                                           + at(idx)]
            assert not torch.isnan(v.real).any(), "read of an unwritten word"
        k = j % ns
        if ns > 1:
            w = tw[off + (torch.arange(1, r) - 1) * ns + k[..., None]]
            v = torch.cat([v[..., :1], v[..., 1:] * w], -1)
        v = _dft(v, r, sign)
        if st == len(rad) - 1:
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
            assert sorted(a[sel].tolist()) == every_word, "exchange layout"
            buf = bufs[st % g["BUFS"]]
            buf.fill_(nan)
            buf[:, a[sel]] = v[:, sel]
        off += (r - 1) * ns
        ns *= r
    assert off == len(tw)
    return y.real, y.imag


def _ref(x, axis, sign, scale):
    return (np.fft.fft(x, axis=axis) if sign < 0
            else np.fft.ifft(x, axis=axis, norm="forward")) * scale


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_f64_column_emulation_matches_numpy(n, sign):
    cols = _cols_geometry(n)["C"]
    rng = np.random.default_rng(n + (sign > 0))
    vmax = cols + 3
    xr = torch.from_numpy(rng.standard_normal((3, n, vmax)))
    xi = torch.from_numpy(rng.standard_normal((3, n, vmax)))
    scale = 1.0 / np.sqrt(n)
    for p_, v_ in ((1, 1), (1, 37), (3, cols + 3)):
        cr, ci = xr[:p_, :, :v_].contiguous(), xi[:p_, :, :v_].contiguous()
        er, ei = _emulate_cols(cr, ci, sign, scale)
        assert er.dtype == torch.float64
        want = _ref(cr.numpy() + 1j * ci.numpy(), 1, sign, scale)
        assert rel_l2(er.numpy() + 1j * ei.numpy(), want) <= tolerance(
            n, "complex128")


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_f64_row_emulation_matches_numpy(n, sign):
    rpb = _row_geometry(n)["RPB"]
    rng = np.random.default_rng(2 * n + (sign > 0))
    for b_rows in (1, rpb + 1 if rpb > 1 else 3):
        xr = torch.from_numpy(rng.standard_normal((b_rows, n)))
        xi = torch.from_numpy(rng.standard_normal((b_rows, n)))
        er, ei = _emulate_rows(xr, xi, sign, 0.5)
        assert er.dtype == torch.float64
        want = _ref(xr.numpy() + 1j * xi.numpy(), 1, sign, 0.5)
        assert rel_l2(er.numpy() + 1j * ei.numpy(), want) <= tolerance(
            n, "complex128")


def _worst_slot(accesses):
    """The worst count of distinct 8-byte words one slot (word % 16) serves
    in a half-warp access, over (threads, butterflies, r) word tensors and
    their live masks (1: conflict-free)."""
    worst = 1
    for addr, live in accesses:
        for h0 in range(0, addr.shape[0], 16):
            for b in range(addr.shape[1]):
                for q in range(addr.shape[2]):
                    a = addr[h0:h0 + 16, b, q][live[h0:h0 + 16, b, q]]
                    for slot in set((a % 16).tolist()):
                        worst = max(worst, len(set(a[a % 16 == slot]
                                                   .tolist())))
    return worst


def _phases(rad, n, tpu, lane, place):
    """The shared reads and writes of every exchange, as (words, live)
    pairs: ``tpu`` threads a unit (a column's lanes or a row's), ``lane``
    each thread's lane in its unit, ``place`` maps element indices
    (threads, butterflies, r) to words."""
    out, ns = [], 1
    for st, r in enumerate(rad):
        m = n // r
        nb = -(-m // tpu)
        jraw = lane[:, None] + torch.arange(nb) * tpu
        j = jraw.clamp(max=m - 1)
        k = j % ns
        if st > 0:
            reads = place(j[..., None] + torch.arange(r) * m)
            out.append((reads, torch.ones_like(reads, dtype=torch.bool)))
        if st < len(rad) - 1:
            base = (j - k) * r + k
            writes = place(base[..., None] + torch.arange(r) * ns)
            out.append((writes, (jraw < m)[..., None].expand(writes.shape)))
        ns *= r
    return out


@pytest.mark.parametrize("kernel", ["cols", "last"])
@pytest.mark.parametrize("n", [n for n in LENGTHS if n > 16])
def test_f64_exchanges_bank_conflicts(n, kernel):
    """Every exchange of both f64 tiles, at every length, serves each half
    warp's 16 eight-byte words from 16 distinct slots: the column tiles of
    16 or more columns put one x of 16 neighbouring columns in a half warp,
    the 8-column tile of n = 1024 swizzles its 16-word rows, and the rows'
    XOR swizzle (from 512 on) and pad word (below) spread the stride-16
    writes of the radix-16 stages."""
    if kernel == "cols":
        g = _cols_geometry(n)
        tid = torch.arange(g["THREADS"])
        c = tid % g["C"]

        def place(x):
            return _col_at(x, c[:, None, None], g["C"])
        acc = _phases(sk.cols_stages(n), n, g["TPC"], tid // g["C"], place)
    else:
        g = _row_geometry(n)
        tid = torch.arange(g["THREADS"])
        rl = tid // g["TPR"]
        at = _row_layout(n)

        def place(x):
            return rl[:, None, None] * g["PITCH"] + at(x)
        acc = _phases(sk.last_stages(n), n, g["TPR"], tid % g["TPR"], place)
    assert _worst_slot(acc) == 1


@pytest.mark.parametrize("name,shape", [("fft_cols", (3, 512, 37)),
                                        ("fft_cols", (1, 64, 5)),
                                        ("fft_last", (5, 1024)),
                                        ("fft_last", (37, 16))])
def test_f64_wrappers_on_cpu_planes(name, shape):
    """f64 CPU planes run the plain version in f64 (float64 tables, no f32
    on the way) within tolerance(n, "complex128") of numpy, and count no
    launch."""
    rng = np.random.default_rng(len(shape) + shape[1])
    xr = torch.from_numpy(rng.standard_normal(shape))
    xi = torch.from_numpy(rng.standard_normal(shape))
    before = dict(sk.LAUNCHES)
    yr, yi = getattr(sk, name)(xr, xi, -1, 0.25)
    assert sk.LAUNCHES == before
    assert yr.dtype == yi.dtype == torch.float64
    axis = 1 if name == "fft_cols" else -1
    want = _ref(xr.numpy() + 1j * xi.numpy(), axis, -1, 0.25)
    assert rel_l2(yr.numpy() + 1j * yi.numpy(), want) <= tolerance(
        shape[axis], "complex128")
