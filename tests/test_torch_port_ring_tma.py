"""The slab ring (csrc/ring.cu) fed by TMA bulk copies: its geometry, its
index schemes and its wrapper, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against ``fft_axis_ring_plain`` at every length and all 93 fused pairs).
Here:

* the fuse_last mode (``fft_axes2_ring``): for each of the 93 pairs
  ``fused2_ring_supported`` admits, f32 and bf16 planes, the geometry of
  ``stockham_kernels.axes2_ring_geometry`` (the mirror of the kernel's):
  the cluster size divides n1, n2 is a multiple of 8*C, the stripe, the
  padded rows, the stage lists and the mbarriers fit in 227 KB, every TMA
  box lands 128-byte aligned in rows that are a multiple of 16 bytes and
  inside its own sub-slab's place, the boxes of a sub-slab fill that place
  once, each mbarrier's transaction stays under 2^20 bytes, and the
  sub-slabs whose copies go out after the gather lie below the rows; and
  the index scheme of the stripe (sub-slab-major, as the boxes land it) and
  of the row gather, emulated in numpy with whole-axis FFTs in place of the
  butterflies, is held against ``numpy.fft.fft2``;
* the axis mode (``fft_axis_ring``): for every length the mid-axis gate
  admits (the lengths of ``cols_stages`` and of the COLS_CASE table the
  ring shares), both plane types: the tile width, ring depth and box
  geometry of ``ring_geometry`` (inner box bytes a multiple of 16, box
  dimensions <= 256, the ring and the exchange buffer within 227 KB, the
  slab places 128-byte aligned), and the ring's schedule (items walked by
  the persistent blocks, the slab and mbarrier phase of each item, the
  refill of a slab with the item K later) emulated with the landed slab's
  zero-filled ragged columns;
* the wrappers: the bf16 fuse_last entry takes ``fft_fused2``'s arguments
  (no f32 scratch planes, no scratch count), and a call with the launch
  stubbed allocates nothing but its two output planes and passes the
  arguments each C signature names;
* the old two-pass body is gone: its names no longer appear in the sources.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from regent_fft_tpu_torch.ops import _build
from regent_fft_tpu_torch.ops import fourstep as fs
from regent_fft_tpu_torch.ops import stockham_kernels as sk

CSRC = Path(sk.__file__).resolve().parent.parent / "csrc"
SMEM_MAX = 232448
TX_MAX = 1 << 20
DTYPES = [torch.float32, torch.bfloat16]
PAIRS = [(a, b) for a in range(16, 2049) for b in range(128, 2049, 128)
         if sk.fused2_ring_supported(a, b)]
LENGTHS = [n for n in range(2, sk.MAX_STOCKHAM_N + 1)
           if sk.kernel_len_ok(n, False)]
COLS_CASES = {int(m.group(1)): (int(m.group(2)),
                                tuple(int(v) for v in m.group(5).split(",")))
              for m in re.finditer(
                  r"COLS_CASE\((\d+), (\d+), (\d+), (\d+), ([0-9, ]+)\)",
                  (CSRC / "cols.cuh").read_text())}


def _es(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def test_pairs_and_lengths():
    """93 fused pairs, all inside fft_fused2's gate; 24 axis lengths, the
    ones the column body's instance table compiles."""
    assert len(PAIRS) == 93
    assert all(sk.fused2_supported(a, b) for a, b in PAIRS)
    assert (512, 512) in PAIRS and (16, 2048) in PAIRS
    assert set(LENGTHS) == set(COLS_CASES) and len(LENGTHS) == 24


# --- fuse_last ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n1,n2", PAIRS)
def test_axes2_geometry(n1, n2, dtype):
    es = _es(dtype)
    for planes in (1, 3, 512):
        g = sk.axes2_ring_geometry(n1, n2, planes, dtype)
        c, w, ws, sub = g["C"], g["w"], g["ws"], g["subslabs"]
        assert c == sk.fused2_cluster(n1, n2, planes)
        assert n1 % c == 0 and n2 % (8 * c) == 0 and w * c == n2
        assert sub in (1, 2, 4) and ws * sub == w and ws % 4 == 0
        assert (ws * es) % 16 == 0 and ws <= sk.TMA_BOX_MAX
        # two where a half-stripe row is a box row; one only for bf16
        # stripes of 8, 24, 40 or 56 columns; four for w = 640..1024
        half = w // 2
        assert (sub == 2) == (half <= 256 and half % 4 == 0
                              and (half * es) % 16 == 0)
        assert sub != 1 or (dtype == torch.bfloat16 and w in (8, 24, 40, 56))
        assert sub != 4 or 640 <= w <= 1024
        assert g["smem_bytes"] + g["static_bytes"] <= SMEM_MAX
        assert g["smem_bytes"] - sk.SMEM_ALIGN == 8 * g["part_words"]
        assert g["part_words"] % 32 == 0
        # the stripe and the rows fit the part; the stripe's sub-slabs
        # cover its n1 x w words
        nw = n1 * ws
        assert sub * nw == n1 * w
        assert g["rows_word"] + g["h"] * (n2 + n2 // 32) <= g["part_words"]
        assert g["tx_bytes"] == 2 * nw * es < TX_MAX
        br = g["box_rows"]
        assert br <= sk.TMA_BOX_MAX and n1 % br == 0
        covered = {}
        for s_, p_, off, row_bytes, rows in g["copies"]:
            assert off % sk.SMEM_ALIGN == 0 and row_bytes % 16 == 0
            assert row_bytes == ws * es and rows == br
            place = 4 * (p_ * g["part_words"] + s_ * nw)
            lo = place + (2 * nw if es == 2 else 0)   # bf16: upper half
            assert lo <= off and off + rows * row_bytes <= place + 4 * nw
            covered.setdefault((s_, p_), []).append((off, rows * row_bytes))
        for (s_, p_), spans in covered.items():
            spans.sort()
            assert sum(b for _, b in spans) == nw * es
            assert all(a + b == a2 for (a, b), (a2, _) in
                       zip(spans, spans[1:]))
        assert sum(len(v) for v in covered.values()) == len(g["copies"])
        assert len(covered) == 2 * sub
        # the next plane's early copies go where the row pass never writes:
        # the lower half of the stripe
        for s_ in g["early"]:
            assert (s_ + 1) * nw <= g["rows_word"]
        assert g["early"] == list(range(sub // 2))
        # a column stage of a sub-slab: 512 threads of ELEMS = 32/S values
        # cover its n1*ws points
        assert 512 * (32 // sub) >= nw


def _stripes(x, c, ws, sub):
    """Each CTA's stripe as the TMA boxes land it: sub-slab s of CTA k holds
    columns [k*w + s*ws, +ws) of every row, row-major (s*N + j*ws + t)."""
    n1, n2 = x.shape
    w = n2 // c
    out = np.empty((c, sub * n1 * ws), x.dtype)
    for k in range(c):
        for s_ in range(sub):
            blk = x[:, k * w + s_ * ws: k * w + (s_ + 1) * ws]
            out[k, s_ * n1 * ws:(s_ + 1) * n1 * ws] = blk.reshape(-1)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n1,n2", PAIRS[::3] + [(512, 512), (2048, 128)])
def test_axes2_index_scheme(n1, n2, dtype):
    """Column pass in each sub-slab (ws transforms of n1 points, element i
    of transform t at s*N + i*ws + t), then the gather: element i of CTA
    c's row t from CTA i // w, sub-slab (i % w) // ws, word
    sub*N + (c*h + t)*ws + (i % w) - sub*ws; then the row pass; the output
    row t of CTA c is plane row c*h + t.  Equals fft2 of the plane, for
    the geometry of 3 planes and of 512 (larger clusters, or wider
    stripes)."""
    rng = np.random.default_rng(n1 * 7 + n2)
    x = rng.standard_normal((n1, n2)) + 1j * rng.standard_normal((n1, n2))
    for planes in (3, 512):
        _gather_matches_fft2(x, sk.axes2_ring_geometry(n1, n2, planes, dtype))


def _gather_matches_fft2(x, g):
    n1, n2 = x.shape
    c, w, h, ws, sub = g["C"], g["w"], g["h"], g["ws"], g["subslabs"]
    nw = n1 * ws
    st = _stripes(x, c, ws, sub)
    for k in range(c):
        for s_ in range(sub):
            blk = st[k, s_ * nw:(s_ + 1) * nw].reshape(n1, ws)
            st[k, s_ * nw:(s_ + 1) * nw] = np.fft.fft(blk, axis=0).ravel()
    y = np.empty_like(x)
    i = np.arange(n2)
    seg = i // w
    col = i - seg * w
    sb = col // ws
    for k in range(c):
        for t in range(h):
            at = sb * nw + (k * h + t) * ws + col - sb * ws
            assert at.min() >= 0 and at.max() < sub * nw
            y[k * h + t] = st[seg, at]
    # 16-byte gathers: a group of four never crosses a sub-slab or a CTA
    assert ws % 4 == 0 and w % 4 == 0
    y = np.fft.fft(y, axis=1)
    np.testing.assert_allclose(y, np.fft.fft2(x), rtol=0, atol=1e-9 * n1 * n2)


@pytest.mark.parametrize("planes,nclus", [(512, 8), (3, 8), (37, 7), (1, 1)])
def test_axes2_persistent_walk(planes, nclus):
    """Cluster q walks planes q, q + Q, ...: every plane once; the copies of
    a plane's sub-slabs are issued once (at the start for its first plane,
    else during the cluster's previous plane), so each mbarrier completes
    one phase a plane and the waits alternate parities 0, 1, 0, ..."""
    grid = min(planes, nclus)
    seen = []
    for q in range(grid):
        walk = list(range(q, planes, grid))
        seen += walk
        issued = [walk[0]] + [pl + grid for pl in walk if pl + grid < planes]
        assert issued == walk
        assert [i & 1 for i in range(len(walk))] == [
            i % 2 for i in range(len(walk))]
    assert sorted(seen) == list(range(planes))


# --- axis mode ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_axis_ring_geometry(n, dtype):
    es = _es(dtype)
    g = sk.ring_geometry(n, dtype)
    _, rad = COLS_CASES[n]
    e = g["E"]
    assert rad == sk.cols_stages(n) and n % e == 0 and e % rad[0] == 0
    # twice the first radix only where the narrowest tile would need more
    # than 512 threads (bf16 at n = 1536, 2048)
    assert (e == rad[0]) == (n // rad[0] * (16 // es) <= 512)
    c = g["C"]
    assert c & (c - 1) == 0 and c <= sk.TMA_BOX_MAX
    assert (c * es) % 16 == 0 and c * es >= 16
    assert g["threads"] == n // e * c <= 512
    br = g["box_rows"]
    assert br <= sk.TMA_BOX_MAX and n % br == 0 and g["boxes"] * br == n
    k = g["depth"]
    assert 1 <= k <= sk.RING_MAX_K
    assert k >= 2 or (n, dtype) == (2048, torch.bfloat16)
    assert g["raw_bytes"] % sk.SMEM_ALIGN == 0
    assert g["raw_bytes"] >= 2 * n * c * es == g["tx_bytes"] < TX_MAX
    assert g["exchange_bytes"] == (8 * n * c if len(rad) > 1 else 0)
    assert (g["smem_bytes"] == k * g["raw_bytes"] + g["exchange_bytes"]
            + sk.SMEM_ALIGN)
    assert g["smem_bytes"] + 16 * k <= SMEM_MAX
    # every box's place: the re tile at the slab, the im tile n*C elements
    # on, box b BR*C elements into its tile
    for part in (0, 1):
        for b in range(g["boxes"]):
            off = (part * n * c + b * br * c) * es
            assert off % sk.SMEM_ALIGN == 0 or n * c * es < sk.SMEM_ALIGN
            assert off + br * c * es <= g["raw_bytes"]
    # a wider tile would leave the ring shallower than 2 (or the block
    # over 512 threads), and a narrower one is not taken
    if 2 * c <= sk.TMA_BOX_MAX and n // e * 2 * c <= 512:
        assert sk._ring_depth(n, 2 * c, len(rad), es) < 2


def test_axis_ring_main_shape():
    """At n = 512: 16 columns of 512 threads (16 values each), K = 2 slabs
    of 64 KiB in f32, K = 4 of 32 KiB in bf16, two boxes of 256 rows
    each."""
    f, b = (sk.ring_geometry(512, dt) for dt in DTYPES)
    assert (f["C"], f["E"], f["threads"], f["depth"], f["raw_bytes"]) == (
        16, 16, 512, 2, 65536)
    assert (b["C"], b["depth"], b["raw_bytes"]) == (16, 4, 32768)
    assert f["boxes"] == b["boxes"] == 2 and f["box_rows"] == 256


def _ring_schedule(items, grid, k):
    """The axis kernel's schedule: block `blk` takes items blk, blk + grid,
    ...; its i-th item waits on slab i % K at phase (i // K) & 1; slabs
    0..K-1 are loaded first, then slab i % K with item i + K once item i's
    stage 0 has read it."""
    log = []
    for blk in range(grid):
        count = (items - 1 - blk) // grid + 1 if blk < items else 0
        mine = [blk + i * grid for i in range(count)]
        loaded = {i: mine[i] for i in range(min(k, count))}
        for i in range(count):
            b, phase = i % k, (i // k) & 1
            assert loaded.pop(i) == mine[i]
            if i + k < count:
                loaded[i + k] = mine[i + k]
            log.append((mine[i], blk, b, phase))
    return log


@pytest.mark.parametrize("pre,post,n,dtype", [
    (1, 262144, 512, torch.float32), (1, 262144, 512, torch.bfloat16),
    (3, 40, 2048, torch.bfloat16), (5, 4, 16, torch.float32),
    (2, 264, 96, torch.float32), (7, 1000, 384, torch.bfloat16)])
def test_axis_ring_items_and_ragged_tiles(pre, post, n, dtype):
    """Every (plane, tile) item is taken once; the item's rows are
    [pl*n, (pl+1)*n) of the (pre*n, post) view and its columns
    [tile*C, +C), the ones past `post` zero-filled as the map fills them
    and never stored; each slab alternates its mbarrier phase."""
    g = sk.ring_geometry(n, dtype)
    c, k = g["C"], g["depth"]
    ntiles = -(-post // c)
    items = pre * ntiles
    grid = min(items, 132)
    log = _ring_schedule(items, grid, k)
    assert sorted(i for i, *_ in log) == list(range(items))
    rng = np.random.default_rng(n)
    x = rng.standard_normal((pre * n, post))
    y = np.zeros_like(x)
    stored = np.zeros(x.shape, int)
    for item, _, _, _ in log:
        pl, tile = divmod(item, ntiles)
        slab = np.zeros((n, c))
        cols = min(c, post - tile * c)
        slab[:, :cols] = x[pl * n:(pl + 1) * n, tile * c: tile * c + cols]
        for cc in range(c):
            if tile * c + cc < post:
                y[pl * n:(pl + 1) * n, tile * c + cc] = slab[:, cc]
                stored[pl * n:(pl + 1) * n, tile * c + cc] += 1
    assert np.array_equal(y, x) and (stored == 1).all()
    phases = {}
    for _, blk, b, phase in log:
        phases.setdefault((blk, b), []).append(phase)
    for seq in phases.values():
        assert seq == [i & 1 for i in range(len(seq))]


# --- wrappers ----------------------------------------------------------------
def _c_params(src, name):
    m = re.search(rf"\nint {name}\(([^)]*)\)", src)
    return [p.strip() for p in m.group(1).split(",")]


def test_bf16_entries_take_no_scratch():
    """The bf16 ring entries take the f32 entries' arguments; the fuse_last
    pair takes fft_fused2's (the cluster size after the shape), with no
    scratch planes or scratch count anywhere on the route."""
    sig = _build._SIGNATURES
    assert sig["fft_axes2_ring_bf16"] == sig["fft_axes2_ring"] == sig[
        "fft_fused2"]
    assert sig["fft_axis_ring_bf16"] == sig["fft_axis_ring"]
    src = (CSRC / "ring.cu").read_text()
    for name in ("fft_axis_ring", "fft_axis_ring_bf16", "fft_axes2_ring",
                 "fft_axes2_ring_bf16", "fft_axes2_ring_clusters",
                 "fft_axis_ring_residency"):
        params = _c_params(src, name)
        assert len(params) == len(sig[name]), name
        assert not any(re.search(r"\b(mr|mi|nscr)\b", p) for p in params)
    assert "nscr" not in inspect.getsource(fs)
    assert "nscr" not in src


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fuse", [False, True])
def test_wrapper_allocates_only_the_output(monkeypatch, dtype, fuse):
    """With the CUDA launch stubbed, the wrapper hands each C entry the
    arguments its signature names (the launch appends the stream) and
    allocates nothing but its two output planes; the fuse_last call passes
    the cluster size and fused2_stages tables, the axis call cols_stages
    tables."""
    calls, allocs, tables = [], [], []
    monkeypatch.setattr(sk, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(sk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(sk, "_c2c_entry",
                        lambda name, xr: (name + sk.C2C_DTYPES[xr.dtype],
                                          None))
    monkeypatch.setattr(sk, "_launch",
                        lambda name, fn, dev, *args: calls.append((name,
                                                                   args)))

    def fake_tables(n, sign, device, stages=None):
        tables.append((n, stages.__name__ if stages else None))
        return torch.zeros((1, 2)), None, 1
    monkeypatch.setattr(sk, "device_tables", fake_tables)
    real_empty_like, real_empty = torch.empty_like, torch.empty

    def empty_like(*a, **k):
        allocs.append("empty_like")
        return real_empty_like(*a, **k)

    def empty(*a, **k):
        allocs.append("empty")
        return real_empty(*a, **k)
    monkeypatch.setattr(torch, "empty_like", empty_like)
    monkeypatch.setattr(torch, "empty", empty)
    shape = (4, 512, 512) if fuse else (2, 512, 1024)
    xr = real_empty(shape, dtype=dtype)
    xi = real_empty(shape, dtype=dtype)
    yr, yi = fs.fft_axis_ring(xr, xi, -1, 0.5, fuse)
    assert yr.shape == shape and yr.dtype == dtype
    assert allocs == ["empty_like", "empty_like"]
    (name, args), = calls
    base = "fft_axes2_ring" if fuse else "fft_axis_ring"
    assert name == base + ("_bf16" if dtype == torch.bfloat16 else "")
    assert len(args) + 1 == len(_build._SIGNATURES[name])
    if fuse:
        assert args[4:8] == (4, 512, 512, sk.fused2_cluster(512, 512, 4))
        assert tables == [(512, "fused2_stages"), (512, "fused2_stages")]
    else:
        assert args[4:7] == (2, 512, 1024)
        assert tables == [(512, "cols_stages")]


@pytest.mark.parametrize("dtype,post", [(torch.float32, 6),
                                        (torch.bfloat16, 12)])
def test_wrapper_refuses_rows_under_16_bytes(monkeypatch, dtype, post):
    monkeypatch.setattr(sk, "_on_cuda", lambda *a, **k: True)
    x = torch.zeros((2, 64, post), dtype=dtype)
    with pytest.raises(ValueError, match="multiple of"):
        fs.fft_axis_ring(x, x, -1)


# --- the old body is gone ----------------------------------------------------
@pytest.mark.parametrize("name", [
    "cp_async4", "cp_async8", "cp_async16", "cp_async_commit", "load_rows",
    "load_rows_raw", "widen_rows", "work_rows", "work_cols", "load_cols",
    "widen_cols", "launch_ring", "rows_geo", "rows_smem_bytes", "fft_tile",
    "cp.async.cg", "commit_group", "wait_group", "RING_K"])
def test_old_ring_body_is_gone(name):
    assert name not in (CSRC / "ring.cu").read_text()


@pytest.mark.parametrize("name", ["rows_geo", "rows_smem_bytes",
                                  "fft_tile<true>", "at<true>", "ROWS",
                                  "g.pitch"])
def test_row_mode_of_the_shared_tile_is_gone(name):
    for src in sorted(CSRC.glob("*.cu*")):
        assert name not in src.read_text(), src.name


def test_ring_kernels_are_tma_fed():
    """Both modes load through 2-D tensor-map copies completing mbarrier
    transactions, the fuse_last mode on a cluster."""
    src = (CSRC / "ring.cu").read_text()
    for expr in ("cp.async.bulk.tensor.2d", "mbarrier::complete_tx",
                 "mbarrier.try_wait.parity", "cuTensorMapEncodeTiled",
                 "fence.proxy.async.shared::cta",
                 "cudaLaunchAttributeClusterDimension",
                 "cols_stage<RingIO<T, G>", "f2_stage_of<true, ELEMS>"):
        assert expr in src, expr
