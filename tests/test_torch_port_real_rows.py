"""The real pair kernels ``fft_last_r2c`` and ``ifft_last_c2r`` (csrc/real.cu,
on the row body of csrc/last.cuh) emulated on the CPU.

One row of the body is one pair p of real rows 2p and 2p+1: T = n / R0
threads a pair (R0 the first radix of ``last_stages``, one thread a pair for
n <= 16), ``last_geometry(n)[1]`` pairs a block.  An odd B leaves row 2p+1
of the last pair out (it reads as zero, nothing is written for it); the
pairs past the end of a ragged last block read the last pair again and
write nothing.

- R2C: stage 0 reads row 2p into the real and row 2p+1 into the imaginary
  part (thread j takes elements j + r*T); the stages of ``last_stages`` run
  with sign -1; the last stage writes Z = FFT(z) in natural order into the
  shared buffer the stage list leaves free, and after one barrier lane l
  untangles bins l + i*T from Z[k] and Z[(n-k) mod n] (in registers for
  n <= 16) and writes X1 to row 2p and X2 to row 2p+1 with the scale.
- C2R: stage 0 builds element x = j + r*T of the spectrum of z = x1 + i x2
  from the half spectra: bin k = x for r < R0/2, the descending run
  k = n - x for r >= R0/2 (conjugated); the imaginary parts of bins 0 and
  n/2 read as zero and packed bin n/2 is bin 0's imaginary slot.  The stages
  run with sign +1; the last stage writes Re z to row 2p and Im z to row
  2p+1 with the scale.

The emulation follows that index scheme in torch, in f32 (complex64), with
NaN-filled shared buffers and outputs: every device-memory read lies inside
its row, every shared read finds a written word, every output word is
written exactly once.  It runs at every length ``r2c_last_supported``
admits, both layouts, B = 1 and an odd B that leaves a ragged last block,
scale != 1, and is held against the plain versions and the JAX
``fft_last_r2c_stockham`` / ``ifft_last_c2r_stockham`` in interpret mode
(packed through the narrow runner where the JAX gate refuses packed rows)
within ``tolerance(n)``.  The instance table of csrc/real.cu (``REAL_CASE``)
is read from the source and held against ``last_stages``, and the bank
conflicts of the R2C untangle's shared accesses are counted.
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

LENGTHS = [n for n in range(2, sk.MAX_REAL_N + 1) if sk.r2c_last_supported(n)]
CSRC = Path(__file__).resolve().parent.parent / "regent_fft_tpu_torch" / "csrc"
NAN = float("nan")


def test_admitted_lengths():
    """The ten lengths of the real-kernel gate: powers of two 2..1024."""
    assert LENGTHS == [2 ** k for k in range(1, 11)]
    for n in LENGTHS:
        assert jps.r2c_last_supported(n)


def test_c_instances_match_last_stages():
    """csrc/real.cu compiles one instance per admitted length with the stage
    list of last_stages, on the row body of csrc/last.cuh, and no longer
    runs the shared-memory tile."""
    src = (CSRC / "real.cu").read_text()
    cases = {int(m.group(1)): tuple(int(v) for v in m.group(2).split(","))
             for m in re.finditer(r"REAL_CASE\((\d+), ([0-9, ]+)\)", src)}
    assert cases == {n: sk.last_stages(n) for n in LENGTHS}
    assert '#include "last.cuh"' in src
    code = re.sub(r"//[^\n]*", "", src)
    for old in ("fft_tile", "rows_geo", "rows_smem_bytes", "StagePlan"):
        assert old not in code
    assert "last_stage<RealIO<MODE>" in code


def _layout(n):
    """Where word x of a row lies in the row's part of a shared buffer, and
    the row pitch: swizzled within 32-word groups from n = 512 on, padded
    one word every 16 below (csrc/last.cuh, LastGeo)."""
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


def _gather(flat, addr):
    """A device-memory read: every address inside the array."""
    assert int(addr.min()) >= 0 and int(addr.max()) < flat.numel()
    return flat[addr]


class _Out:
    """An output plane, NaN-filled: every word written exactly once."""

    def __init__(self, size):
        self.y = torch.full((size,), NAN)
        self.seen = []

    def put(self, addr, val, sel):
        a = addr.expand(val.shape)[sel]
        self.y[a] = val[sel]
        self.seen += a.tolist()

    def done(self):
        assert len(set(self.seen)) == len(self.seen) == self.y.numel()
        assert not torch.isnan(self.y).any()
        return self.y


def _exchange(buf, a, v, keep, every_word):
    """A block-wide write of shared buffer `buf` (NaN-filled first): word
    a[thr, b, r] takes v[blk, thr, b, r] where the butterfly is kept; every
    word of every row's part written once."""
    sel = keep[..., None].expand(a.shape)
    assert sorted(a[sel].tolist()) == every_word, "exchange layout"
    buf.fill_(complex(NAN, NAN))
    buf[:, a[sel]] = v[:, sel]


def _emulate_real_rows(mode, n, b_rows, packed, scale, x=None, hr=None,
                       hi=None):
    """The index scheme of fft_last_r2c_kernel (mode "r2c", x: (B, n) f32
    rows) or ifft_last_c2r_kernel (mode "c2r", hr/hi: (B, w) half-spectrum
    planes), every block and thread at once: (block, thread, butterfly, r)
    index tensors.  Returns (yr, yi) of shape (B, w), or y of (B, n)."""
    r2c = mode == "r2c"
    rad = sk.last_stages(n)
    sign = -1 if r2c else 1
    tpr, rpb = sk.last_geometry(n)
    at, pitch = _layout(n)
    m = n // 2
    w = m if packed else m + 1
    pairs = (b_rows + 1) // 2
    nblk = -(-pairs // rpb)
    tid = torch.arange(tpr * rpb)
    rl, lane = tid // tpr, tid % tpr
    pair = torch.arange(nblk)[:, None] * rpb + rl           # (blk, thr)
    valid = pair < pairs
    row = 2 * torch.where(valid, pair, torch.full_like(pair, pairs - 1))
    valid2 = row + 1 < b_rows
    width = n if r2c else w
    off = (row * width)[..., None]                          # (blk, thr, 1)
    off2 = torch.where(valid2, row * width + width, row * width)[..., None]
    v2 = valid2[..., None]
    # stage 0: one butterfly a thread, element x = lane + r*T
    r0 = rad[0]
    assert n // r0 == tpr
    r = torch.arange(r0)
    idx = lane[:, None] + r * tpr                           # (thr, r)
    if r2c:
        xf = x.reshape(-1)
        re_ = _gather(xf, off + idx)
        im_ = torch.where(v2, _gather(xf, off2 + idx), torch.zeros(()))
    else:
        mirror = 2 * r >= r0                                # x >= n/2
        k = torch.where(mirror, n - idx, idx)
        first = lane[:, None] == 0
        edge = first & ((r == 0) | (2 * r == r0))           # bins 0, n/2
        nyq = first & (2 * r == r0) & packed                # packed bin n/2
        kr, ki = torch.where(nyq, 0, k), torch.where(edge, 0, k)
        assert int(k.min()) >= 0 and int(kr.max()) < w and int(ki.max()) < w

        def load(o):
            xr_ = torch.where(nyq, _gather(hi.reshape(-1), o + kr),
                              _gather(hr.reshape(-1), o + kr))
            xi_ = torch.where(edge, 0.0, _gather(hi.reshape(-1), o + ki))
            return xr_, xi_
        x1r, x1i = load(off)
        x2r, x2i = (torch.where(v2, t, torch.zeros(())) for t in load(off2))
        re_ = torch.where(mirror, x1r + x2i, x1r - x2i)
        im_ = torch.where(mirror, x2r - x1i, x1i + x2r)
    v = torch.complex(re_, im_)[:, :, None, :]             # (blk, thr, 1, r)
    bufs = [torch.full((nblk, rpb * pitch), complex(NAN, NAN),
                       dtype=torch.complex64) for _ in range(2)]
    words = at(torch.arange(n))
    assert len(set(words.tolist())) == n and int(words.max()) < pitch
    every_word = sorted(r_ * pitch + x_ for r_ in range(rpb)
                        for x_ in words.tolist())
    tab = sk._stage_tables(rad, sign)
    tw = torch.complex(torch.from_numpy(tab[:, 0]), torch.from_numpy(tab[:, 1]))
    ns, off_tw = 1, 0
    for st, rr in enumerate(rad):
        mm = n // rr
        nb = -(-mm // tpr)
        jraw = lane[:, None] + torch.arange(nb) * tpr       # (thr, nb)
        j = jraw.clamp(max=mm - 1)                          # repeat the last
        keep = jraw < mm
        if st > 0:
            ridx = j[..., None] + torch.arange(rr) * mm
            v = bufs[(st - 1) % 2][:, rl[:, None, None] * pitch + at(ridx)]
            assert not torch.isnan(v.real).any(), "read of an unwritten word"
        else:
            assert nb == 1 and bool(keep.all())
        kk = j % ns
        if ns > 1:
            wv = tw[off_tw + (torch.arange(1, rr) - 1) * ns + kk[..., None]]
            v = torch.cat([v[..., :1], v[..., 1:] * wv], -1)
        v = _dft(v, rr, sign)
        if st < len(rad) - 1:
            base = (j - kk) * rr + kk
            _exchange(bufs[st % 2], rl[:, None, None] * pitch
                      + at(base[..., None] + torch.arange(rr) * ns), v, keep,
                      every_word)
            off_tw += (rr - 1) * ns
            ns *= rr
    assert off_tw + (rad[-1] - 1) * ns == len(tw) and ns * rad[-1] == n
    oidx = j[..., None] + torch.arange(rad[-1]) * ns        # natural order
    if not r2c:                                             # C2R to memory
        y = _Out(b_rows * n)
        sel = (keep[None, :, :, None] & valid[:, :, None, None]).expand(
            v.shape)
        y.put(row[:, :, None, None] * n + oidx, v.real * scale, sel)
        y.put((row + 1)[:, :, None, None] * n + oidx, v.imag * scale,
              sel & valid2[:, :, None, None])
        return y.done().reshape(b_rows, n)
    if len(rad) == 1:                                       # registers
        assert tpr == 1 and ns == 1

        def zat(k_):
            return v[:, :, 0, :][:, :, k_[0]]
    else:                                                   # one exchange
        buf = bufs[(len(rad) - 1) % 2]
        _exchange(buf, rl[:, None, None] * pitch + at(oidx), v, keep,
                  every_word)

        def zat(k_):
            got = buf[:, rl[:, None] * pitch + at(k_)]
            assert not torch.isnan(got.real).any(), "untangle read"
            return got
    # the R2C untangle: lane l takes bins l + i*T, i < (n/2) / T
    assert m % tpr == 0
    kb = lane[:, None] + torch.arange(m // tpr) * tpr       # (thr, i)
    za, zc, zm = zat(kb), zat((n - kb) & (n - 1)), zat(torch.full_like(kb, m))
    x1r, x1i = 0.5 * (za.real + zc.real), 0.5 * (za.imag - zc.imag)
    x2r, x2i = 0.5 * (za.imag + zc.imag), 0.5 * (zc.real - za.real)
    if packed:                              # bin n/2 into bin 0's imag slot
        x1i = torch.where(kb == 0, zm.real, x1i)
        x2i = torch.where(kb == 0, zm.imag, x2i)
    yr, yi = _Out(b_rows * w), _Out(b_rows * w)
    ok = valid[..., None].expand(x1r.shape)
    ok2 = ok & valid2[..., None]
    o1 = (row * w)[..., None] + kb
    for out, a, b in ((yr, x1r, x2r), (yi, x1i, x2i)):
        out.put(o1, a * scale, ok)
        out.put(o1 + w, b * scale, ok2)
    if not packed:                          # narrow bin n/2, lane 0 only
        first = ok[..., :1] & (lane == 0)[None, :, None]
        om = (row * w + m)[..., None]
        zm1 = zm[..., :1]
        yr.put(om, zm1.real * scale, first)
        yi.put(om, torch.zeros(zm1.shape), first)
        yr.put(om + w, zm1.imag * scale, first & valid2[..., None])
        yi.put(om + w, torch.zeros(zm1.shape), first & valid2[..., None])
    return yr.done().reshape(b_rows, w), yi.done().reshape(b_rows, w)


def _batches(n):
    """B = 1 and an odd B that leaves a ragged last block: pairs a block
    + 1 pairs, the last one missing its second row."""
    return (1, 2 * sk.last_geometry(n)[1] + 1)


def _pack(h, n):
    """numpy (B, n/2+1) half spectrum -> the packed (B, n/2) layout."""
    m = n // 2
    p = h[:, :m].copy()
    p.imag[:, 0] = h.real[:, m]
    return p


def _unpack(p, n):
    """The packed (B, n/2) layout -> the narrow (B, n/2+1) half spectrum
    (bin n/2 from bin 0's imaginary slot; both endpoint bins real)."""
    h = np.concatenate([p, p.imag[:, :1].astype(p.dtype)], 1)
    h.imag[:, [0, n // 2]] = 0.0
    return h


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_r2c_emulation_matches_plain_and_jax(n, packed):
    b1, b2 = _batches(n)
    rng = np.random.default_rng(n + packed)
    x = rng.standard_normal((b1 + b2, n)).astype(np.float32)
    scale = 1.0 / np.sqrt(n)
    jr, ji = jps.fft_last_r2c_stockham(jnp.asarray(x), interpret=True)
    yj = (np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)) * scale
    ref = np.fft.rfft(x.astype(np.float64), axis=1) * scale
    if packed:
        yj, ref = _pack(yj, n), _pack(ref, n)
        if jps.r2c_packed_supported(n):
            pr, pi = jps.fft_last_r2c_stockham(jnp.asarray(x), interpret=True,
                                               packed=True)
            direct = (np.asarray(pr, np.float64)
                      + 1j * np.asarray(pi, np.float64)) * scale
            assert rel_l2(direct, yj) <= tolerance(n)
    tx = torch.from_numpy(x)
    for rows in (slice(0, b1), slice(b1, b1 + b2)):
        er, ei = _emulate_real_rows("r2c", n, x[rows].shape[0], packed, scale,
                                    x=tx[rows])
        emu = er.double().numpy() + 1j * ei.double().numpy()
        pr, pi = sk.fft_last_r2c_plain(tx[rows], packed, scale)
        assert rel_l2(emu, pr.double().numpy()
                      + 1j * pi.double().numpy()) <= tolerance(n)
        assert rel_l2(emu, yj[rows]) <= tolerance(n)
        assert rel_l2(emu, ref[rows]) <= tolerance(n)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_c2r_emulation_matches_plain_and_jax(n, packed):
    b1, b2 = _batches(n)
    m = n // 2
    rng = np.random.default_rng(100 + n + packed)
    h = (rng.standard_normal((b1 + b2, m + 1))
         + 1j * rng.standard_normal((b1 + b2, m + 1))).astype(np.complex64)
    xin = _pack(h, n) if packed else h       # endpoint bins not real
    narrow = _unpack(xin, n) if packed else xin
    hr = torch.from_numpy(np.ascontiguousarray(xin.real))
    hi = torch.from_numpy(np.ascontiguousarray(xin.imag))
    scale = 0.375
    hz = narrow.astype(np.complex128)
    hz.imag[:, [0, m]] = 0.0
    ref = np.fft.irfft(hz, n=n, axis=1) * n * scale
    yj = np.asarray(jps.ifft_last_c2r_stockham(
        jnp.asarray(np.ascontiguousarray(narrow.real)),
        jnp.asarray(np.ascontiguousarray(narrow.imag)), n, interpret=True),
        np.float64) * scale
    if packed and jps.r2c_packed_supported(n):
        direct = np.asarray(jps.ifft_last_c2r_stockham(
            jnp.asarray(hr.numpy()), jnp.asarray(hi.numpy()), n,
            interpret=True, packed=True), np.float64) * scale
        assert rel_l2(direct, yj) <= tolerance(n)
    for rows in (slice(0, b1), slice(b1, b1 + b2)):
        emu = _emulate_real_rows("c2r", n, xin[rows].shape[0], packed, scale,
                                 hr=hr[rows], hi=hi[rows]).double().numpy()
        plain = sk.ifft_last_c2r_plain(hr[rows], hi[rows], n, packed, scale)
        assert rel_l2(emu, plain.double().numpy()) <= tolerance(n)
        assert rel_l2(emu, yj[rows]) <= tolerance(n)
        assert rel_l2(emu, ref[rows]) <= tolerance(n)


def _untangle_bank_replays(n):
    """The worst count of distinct words one bank serves in a warp-wide
    shared access of the R2C kernel's added exchange at length n (1:
    conflict-free): (the last stage's natural-order write, the untangle's
    reads of Z[k], its reads of Z[(n-k) mod n]); 32 banks of 4-byte words,
    the (b, r) or round-i accesses of each warp of a block.  Lane 0's reads
    of Z[n/2] are one word a warp."""
    rad = sk.last_stages(n)
    tpr, rpb = sk.last_geometry(n)
    at, pitch = _layout(n)
    tid = torch.arange(tpr * rpb)
    rl, lane = tid // tpr, tid % tpr
    r = rad[-1]
    mm = n // r
    jraw = lane[:, None] + torch.arange(-(-mm // tpr)) * tpr
    ns = n // r
    writes = rl[:, None, None] * pitch + at(jraw.clamp(max=mm - 1)[..., None]
                                            + torch.arange(r) * ns)
    live = (jraw < mm)[..., None].expand(writes.shape)
    kb = lane[:, None] + torch.arange(n // 2 // tpr) * tpr
    direct = rl[:, None] * pitch + at(kb)
    mirror = rl[:, None] * pitch + at((n - kb) & (n - 1))

    def worst(addr, ok):
        addr, ok = addr.reshape(len(tid), -1), ok.reshape(len(tid), -1)
        most = 1
        for w0 in range(0, len(tid), 32):
            for q in range(addr.shape[1]):
                a = addr[w0:w0 + 32, q][ok[w0:w0 + 32, q]]
                for bank in set((a % 32).tolist()):
                    most = max(most, len(set(a[a % 32 == bank].tolist())))
        return most
    every = torch.ones_like(direct, dtype=torch.bool)
    return (worst(writes, live), worst(direct, every), worst(mirror, every))


@pytest.mark.parametrize("n", [n for n in LENGTHS if n >= 32])
def test_untangle_bank_conflicts(n):
    """The natural-order write and the reads of Z[k] are conflict-free at
    every length; the reads of the mirror Z[(n-k) mod n] serve at most two
    words a bank: a warp's run of n-k, descending, crosses one pad word
    (n < 512) or one 32-word swizzle group (n >= 512) where lane 0 sits, so
    lane 0's word shares a bank with one other."""
    write, direct, mirror = _untangle_bank_replays(n)
    assert (write, direct) == (1, 1)
    assert mirror <= 2
