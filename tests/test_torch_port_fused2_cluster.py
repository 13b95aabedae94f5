"""The cluster design of the ``fft_fused2`` kernel (csrc/stockham.cu,
``fft_fused2_kernel``) emulated on the CPU.

The kernel runs one (n1, n2) plane per thread-block cluster of C CTAs.  CTA
c transforms the columns [c*w, (c+1)*w) (w = n2/C) along n1 and keeps them in
its shared memory in f32; after a cluster barrier it takes the rows
[c*h, (c+1)*h) (h = n1/C), gathering element j of a row from CTA j // w at
column j % w, transforms them along n2 and writes them with the scale.  Both
axes run the stage list of :func:`fused2_stages` with its float64-generated
twiddle table.  The host-side choices (the cluster size C, the shared memory
a CTA needs, the stage list) are checked over every pair
``fused2_supported`` admits; the emulation, in torch on the CPU, is held
against ``fft_fused2_plain`` and the JAX ``_runner_fused2`` in interpret
mode within ``tolerance(n1 * n2, dtype)``, in f32 and bf16, both signs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regent_fft_tpu.dtypes import Direction as JDirection
from regent_fft_tpu.ops import pallas_stockham as jps

from regent_fft_tpu_torch.ops import stockham_kernels as sk
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

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
        smem = sk.fused2_smem_bytes(n1, n2, c)
        assert smem <= sk.SMEM_PER_CTA == 232448, (n1, n2, c, smem)
        # the rows start half a stripe up and end past the stripe
        hn = n1 * n2 // c
        assert smem == 8 * (hn // 2 + hn + hn // 32)
        assert hn // 2 + (hn // 2 + hn // 64) >= hn   # upper half past it
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


def _emulate_cluster(xr, xi, sign, scale):
    """fft_fused2_kernel's decomposition on (P, n1, n2) planes."""
    p, n1, n2 = xr.shape
    c = sk.fused2_cluster(n1, n2, p)
    w, h = n2 // c, n1 // c
    x = torch.complex(xr.float(), xi.float())
    # 1. CTA k's stripe: columns [k*w, (k+1)*w) along n1, kept in f32
    stripes = torch.stack([
        _stages(x[:, :, k * w:(k + 1) * w].permute(1, 0, 2).reshape(n1, -1),
                n1, sign).reshape(n1, p, w).permute(1, 0, 2)
        for k in range(c)])                               # (C, P, n1, w)
    # 3. CTA k's rows [k*h, (k+1)*h): element j from CTA j // w, column j % w
    j = torch.arange(n2)
    seg, col = j // w, j % w
    y = torch.empty((p, n1, n2), dtype=torch.complex64)
    for k in range(c):
        for t in range(h):
            row = k * h + t
            gathered = stripes[seg, :, row, col]          # (n2, P)
            y[:, row, :] = _stages(gathered, n2, sign).T
    y = y * scale
    return y.real.to(xr.dtype), y.imag.to(xr.dtype)


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
