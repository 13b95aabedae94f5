#!/usr/bin/env python3
"""Time the f64 instances of the column kernel of ``fft_cols``
(csrc/cols.cu) and the row kernel of ``fft_last`` (csrc/stockham.cu, on
csrc/last.cuh's body) at other tile geometries than the ones their
instance tables ship, to choose the tables.

    python3 scripts/torch_f64_widths.py

Writes a CUDA source under ``build/f64_widths/`` that includes
``csrc/cols.cu`` and ``csrc/last.cuh`` and instantiates each variant below
on f64 planes: a column tile (length n, E values a thread, C columns a
block, the launch bounds' MINB blocks an SM, BUFS shared buffers) or a row
tile (length n, at most BLOCK threads a block, MINB blocks an SM; one
shared buffer where two would keep MINB blocks off an SM).  It builds the
source with ``nvcc`` as ``ops/_build.py`` builds the library and for each
variant prints what the card says of it (resident blocks an SM, registers,
local bytes: any is a spill) and its ms at the main path's shapes (median
of 10 CUDA-event runs, L2 flushed before each), beside the shipped
instance's (``fft_cols``/``fft_last`` through their wrappers on f64
planes) and one ``torch.fft.fft`` call in complex128 in the same run, and
its rel_l2 against that call.  Prints the card's name and power limit,
then one JSON line.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from regent_fft_tpu_torch.ops import _build                    # noqa: E402
from regent_fft_tpu_torch.ops import stockham_kernels as sk    # noqa: E402

# column tiles: ("cols", n, E, C, MINB, BUFS); row tiles: ("last", n,
# BLOCK, MINB)
VARIANTS = [
    ("cols", 512, 16, 16, 1, 1), ("cols", 512, 16, 8, 2, 1),
    ("cols", 512, 16, 8, 1, 2), ("cols", 512, 16, 4, 4, 1),
    ("cols", 512, 32, 8, 1, 1), ("cols", 512, 32, 16, 1, 1),
    ("cols", 256, 16, 16, 2, 1), ("cols", 256, 16, 32, 1, 1),
    ("cols", 1024, 16, 8, 1, 1), ("cols", 1024, 16, 4, 2, 1),
    ("last", 512, 128, 2), ("last", 512, 128, 3), ("last", 512, 128, 4),
    ("last", 512, 256, 2), ("last", 512, 64, 4), ("last", 512, 64, 8),
    ("last", 512, 32, 8),
    ("last", 1024, 128, 2), ("last", 1024, 128, 4), ("last", 1024, 256, 2),
]
# (P, n, V) column planes and (B, n) row planes of the main path: 512^3's
# axes 0 and 1, 64 x 1024's axis 1, 256^3's axes
SHAPES = {("cols", 512): [(1, 512, 262144), (512, 512, 512)],
          ("cols", 256): [(1, 256, 65536), (256, 256, 256)],
          ("cols", 1024): [(1, 1024, 65536)],
          ("last", 512): [(262144, 512)],
          ("last", 1024): [(64, 1024), (65536, 1024)]}

SOURCE = r'''
#include "CSRC/cols.cu"
#include "CSRC/last.cuh"
namespace {
// What the card says of a kernel: resident blocks an SM, registers, local
// bytes, threads, shared bytes.
int attrs(const void* fn, int threads, size_t smem, int* out) {
  cudaError_t e = set_smem(fn, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int b = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, threads, smem);
  out[0] = b;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = threads;
  out[4] = (int)smem;
  return e;
}
// A column geometry with its residency and buffers set by hand.
template <int N_, int E, int C_, int S, int MINB_, int BUFS_>
struct VGeo : ColsGeo<N_, E, C_, S, double> {
  static constexpr int MINB = MINB_;
  static constexpr int BUFS = BUFS_;
  static constexpr size_t SMEM = BUFS_ * ColsGeo<N_, E, C_, S, double>::BUF;
};
// A row tile set by hand.
template <int BLOCK_, int MINB_>
struct VTile {
  static constexpr int BLOCK = BLOCK_;
  static constexpr int MINB = MINB_;
};
// fft_last_kernel on f64 planes at row geometry G.
template <class G, int N, int... R>
__global__ void __launch_bounds__(G::Tile::BLOCK, G::Tile::MINB)
last_v(const double* __restrict__ xr, const double* __restrict__ xi,
       double* __restrict__ yr, double* __restrict__ yi, long long B,
       const double2* __restrict__ tw, double s, double scale) {
  extern __shared__ double vsmem[];
  const int rl = threadIdx.x / G::TPR;
  const long long row = (long long)blockIdx.x * G::RPB + rl;
  LastIO<double> io;
  io.xr = xr;
  io.xi = xi;
  io.yr = yr;
  io.yi = yi;
  io.valid = row < B;
  io.off = (size_t)(io.valid ? row : B - 1) * N;
  io.lane = threadIdx.x - rl * G::TPR;
  last_smem_rows<G>(io, vsmem, rl);
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  last_stage<LastIO<double>, G, N, 0, 1, 0, R...>(io);
}
template <class G, int... R>
int cols_run(void** x, long long P, long long n, long long V,
             const double2* tw, void* st) {
  const long long ntiles = (V + G::C - 1) / G::C;
  const void* fn = (const void*)fft_cols_kernel<double, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  if (e != cudaSuccess) return e;
  fft_cols_kernel<double, G, R...><<<(unsigned)(P * ntiles), G::THREADS,
                                     G::SMEM, (cudaStream_t)st>>>(
      (const double*)x[0], (const double*)x[1], (double*)x[2],
      (double*)x[3], V, (int)ntiles, tw, -1.0, 1.0);
  return cudaGetLastError();
}
template <class G, int... R>
int cols_info(int* out) {
  return attrs((const void*)fft_cols_kernel<double, G, R...>, G::THREADS,
               G::SMEM, out);
}
template <class G, int N, int... R>
int last_run(void** x, long long B, long long n, long long V,
             const double2* tw, void* st) {
  constexpr size_t smem = G::bufs(sizeof...(R)) * G::BUF;
  const void* fn = (const void*)last_v<G, N, R...>;
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return e;
  last_v<G, N, R...><<<(unsigned)((B + G::RPB - 1) / G::RPB), G::THREADS,
                       smem, (cudaStream_t)st>>>(
      (const double*)x[0], (const double*)x[1], (double*)x[2],
      (double*)x[3], B, tw, -1.0, 1.0);
  return cudaGetLastError();
}
template <class G, int N, int... R>
int last_info(int* out) {
  return attrs((const void*)last_v<G, N, R...>, G::THREADS,
               G::bufs(sizeof...(R)) * G::BUF, out);
}
}  // namespace
extern "C" int variant_run(int id, void** x, long long P, long long n,
                           long long V, const double2* tw, void* st) {
  switch (id) {
RUN
  }
  return 1;
}
extern "C" int variant_info(int id, int* out) {
  switch (id) {
INFO
  }
  return 1;
}
'''


def _source() -> str:
    run, info = [], []
    for i, v in enumerate(VARIANTS):
        kind, n = v[0], v[1]
        rad = ", ".join(map(str, sk.cols_stages(n)))
        if kind == "cols":
            _, _, e, c, minb, bufs = v
            geo = f"VGeo<{n}, {e}, {c}, {len(sk.cols_stages(n))}, {minb}, {bufs}>"
            args = f"{geo}, {rad}"
            run.append(f"    case {i}: return cols_run<{args}>(x, P, n, V, "
                       f"tw, st);")
            info.append(f"    case {i}: return cols_info<{args}>(out);")
        else:
            _, _, block, minb = v
            geo = f"LastGeo<{n}, 16, double, VTile<{block}, {minb}>>"
            args = f"{geo}, {n}, {rad}"
            run.append(f"    case {i}: return last_run<{args}>(x, P, n, V, "
                       f"tw, st);")
            info.append(f"    case {i}: return last_info<{args}>(out);")
    return (SOURCE.replace("CSRC", str(_build.SRC_DIR))
            .replace("RUN", "\n".join(run)).replace("INFO", "\n".join(info)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_f64_widths: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out_dir = _build.BUILD_DIR.parent / "f64_widths"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "variants.cu", out_dir / "variants.so"
    src.write_text(_source())
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(src)], check=True)
    print(f"variants built in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.variant_run.argtypes = [ctypes.c_int, ctypes.POINTER(vp), ll, ll, ll,
                                vp, vp]
    lib.variant_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))

    rows = []
    for i, v in enumerate(VARIANTS):
        kind, n = v[0], v[1]
        got = (ctypes.c_int * 5)()
        if lib.variant_info(i, got):
            raise RuntimeError(f"variant {i}: no attributes")
        stages = sk.cols_stages if kind == "cols" else sk.last_stages
        tw = sk.device_tables(n, -1, dev, stages, torch.float64)[0]
        for shape in SHAPES[(kind, n)]:
            xr = torch.randn(shape, device=dev, generator=gen,
                             dtype=torch.float64)
            xi = torch.randn(shape, device=dev, generator=gen,
                             dtype=torch.float64)
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            ptrs = (vp * 4)(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                            yi.data_ptr())
            p_, v_ = (shape[0], shape[2]) if kind == "cols" else (shape[0], 0)
            dim = 1 if kind == "cols" else -1

            def launch():
                err = lib.variant_run(i, ptrs, p_, n, v_, tw.data_ptr(),
                                      stream)
                if err:
                    raise RuntimeError(f"variant {i}: CUDA error {err}")
            launch()
            x = torch.complex(xr, xi)
            ref = torch.fft.fft(x, dim=dim)
            y = torch.complex(yr, yi)
            err = float(torch.linalg.vector_norm(y - ref)
                        / torch.linalg.vector_norm(ref))
            shipped = getattr(sk, "fft_" + kind)
            row = dict(zip(("kind", "n"), v[:2]))
            row.update(dict(zip(("E", "C", "minb", "bufs"), v[2:]))
                       if kind == "cols" else
                       dict(zip(("block", "minb"), v[2:])))
            row.update({"blocks_per_sm": got[0], "registers": got[1],
                        "local_bytes": got[2], "threads": got[3],
                        "smem_bytes": got[4], "shape": shape,
                        "ms": timed(launch),
                        "shipped_ms": timed(lambda: shipped(xr, xi, -1)),
                        "torch_fft_ms": timed(lambda: torch.fft.fft(x,
                                                                    dim=dim)),
                        "bound_ms": 32 * xr.numel() / 3.35e12 * 1e3,
                        "rel_l2": err})
            rows.append(row)
            print(json.dumps(row), flush=True)
            del xr, xi, yr, yi, x, y, ref
            torch.cuda.empty_cache()
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
