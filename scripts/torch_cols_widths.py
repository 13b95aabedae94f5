#!/usr/bin/env python3
"""Time the column kernel of ``fft_cols`` (csrc/cols.cu) at other tile
geometries than the ones its instance table ships, to choose the table.

    python3 scripts/torch_cols_widths.py

Writes a CUDA source under ``build/cols_widths/`` that includes
``csrc/cols.cu`` and instantiates ``fft_cols_kernel`` for each variant
below (length n, plane type, E values a thread, C columns a block, the
launch bounds' MINB blocks an SM, BUFS shared buffers), builds it with
``nvcc`` as ``ops/_build.py`` builds the library, and for each variant
prints what the card says of it (resident blocks an SM, registers, local
bytes: any is a spill) and its ms at the main path's shapes (median of 10
CUDA-event runs, L2 flushed before each), beside the shipped instance's
(``fft_cols`` through its wrapper) in the same run, and its rel_l2 against
``torch.fft``.  Prints the card's name and power limit, then one JSON line.
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

# (n, plane type, E, C, MINB, BUFS)
VARIANTS = [
    (512, "f32", 32, 16, 2, 1), (512, "f32", 16, 16, 1, 2),
    (512, "f32", 32, 32, 1, 1), (512, "f32", 16, 8, 2, 2),
    (512, "f32", 32, 16, 1, 2), (512, "f32", 32, 8, 4, 2),
    (256, "f32", 16, 16, 2, 1), (256, "f32", 16, 32, 1, 1),
    (256, "f32", 32, 32, 2, 1), (256, "f32", 32, 16, 4, 1),
    (1024, "f32", 32, 16, 1, 1), (1024, "f32", 32, 8, 2, 1),
    (1024, "f32", 16, 8, 1, 2),
    (2048, "f32", 32, 8, 1, 1), (2048, "f32", 32, 4, 2, 1),
    (512, "bf16", 32, 32, 1, 1), (512, "bf16", 32, 16, 2, 1),
    (512, "bf16", 16, 16, 1, 2),
    (256, "bf16", 16, 32, 1, 1), (256, "bf16", 32, 32, 2, 1),
    (256, "bf16", 16, 16, 2, 1),
    (1024, "bf16", 32, 16, 1, 1), (1024, "bf16", 32, 8, 2, 1),
    (2048, "bf16", 32, 8, 1, 1),
]
SHAPES = {256: [(1024, 256, 128), (4, 256, 32768)], 512: [(1, 512, 262144)],
          1024: [(1, 1024, 131072)], 2048: [(1, 2048, 65536)]}
TYPES = {"f32": ("float", torch.float32),
         "bf16": ("__nv_bfloat16", torch.bfloat16)}

SOURCE = r'''
#include "CSRC/cols.cu"
namespace {
// A geometry of the kernel with its residency and buffers set by hand.
template <int N_, int E, int C_, int S, int MINB_, int BUFS_>
struct VGeo : ColsGeo<N_, E, C_, S> {
  static constexpr int MINB = MINB_;
  static constexpr int BUFS = BUFS_;
  static constexpr size_t SMEM = BUFS_ * ColsGeo<N_, E, C_, S>::BUF;
};
template <typename T, class G, int... R>
int run(void** x, long long P, long long V, const float2* tw, void* st) {
  const long long ntiles = (V + G::C - 1) / G::C;
  const void* fn = (const void*)fft_cols_kernel<T, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  if (e != cudaSuccess) return e;
  fft_cols_kernel<T, G, R...><<<(unsigned)(P * ntiles), G::THREADS, G::SMEM,
                                (cudaStream_t)st>>>(
      (const T*)x[0], (const T*)x[1], (T*)x[2], (T*)x[3], V, (int)ntiles, tw,
      -1.0f, 1.0f);
  return cudaGetLastError();
}
template <typename T, class G, int... R>
int info(int* out) {
  const void* fn = (const void*)fft_cols_kernel<T, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int b = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, G::THREADS,
                                                      G::SMEM);
  out[0] = b;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = G::THREADS;
  out[4] = (int)G::SMEM;
  return e;
}
}  // namespace
extern "C" int variant_run(int id, void** x, long long P, long long V,
                           const float2* tw, void* st) {
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
    for i, (n, io, e, c, minb, bufs) in enumerate(VARIANTS):
        rad = sk.cols_stages(n)
        args = (f"{TYPES[io][0]}, VGeo<{n}, {e}, {c}, {len(rad)}, {minb}, "
                f"{bufs}>, {', '.join(map(str, rad))}")
        run.append(f"    case {i}: return run<{args}>(x, P, V, tw, st);")
        info.append(f"    case {i}: return info<{args}>(out);")
    return (SOURCE.replace("CSRC", str(_build.SRC_DIR))
            .replace("RUN", "\n".join(run)).replace("INFO", "\n".join(info)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cols_widths: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out_dir = _build.BUILD_DIR.parent / "cols_widths"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "variants.cu", out_dir / "variants.so"
    src.write_text(_source())
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(src)], check=True)
    print(f"variants built in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.variant_run.argtypes = [ctypes.c_int, ctypes.POINTER(vp),
                                ctypes.c_longlong, ctypes.c_longlong, vp, vp]
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
    for i, (n, io, e, c, minb, bufs) in enumerate(VARIANTS):
        got = (ctypes.c_int * 5)()
        if lib.variant_info(i, got):
            raise RuntimeError(f"variant {i}: no attributes")
        dt = TYPES[io][1]
        tw = sk.device_tables(n, -1, dev, sk.cols_stages)[0]
        for shape in SHAPES[n]:
            xr = torch.randn(shape, device=dev, generator=gen).to(dt)
            xi = torch.randn(shape, device=dev, generator=gen).to(dt)
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            ptrs = (vp * 4)(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                            yi.data_ptr())

            def launch():
                err = lib.variant_run(i, ptrs, shape[0], shape[2],
                                      tw.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"variant {i}: CUDA error {err}")
            launch()
            ref = torch.fft.fft(torch.complex(xr.float(), xi.float()), dim=1)
            y = torch.complex(yr.float(), yi.float())
            err = float(torch.linalg.vector_norm(y - ref)
                        / torch.linalg.vector_norm(ref))
            rows.append({"n": n, "type": io, "E": e, "C": c, "minb": minb,
                         "bufs": bufs, "blocks_per_sm": got[0],
                         "registers": got[1], "local_bytes": got[2],
                         "threads": got[3], "smem_bytes": got[4],
                         "shape": shape, "ms": timed(launch),
                         "shipped_ms": timed(lambda: sk.fft_cols(xr, xi, -1)),
                         "rel_l2": err})
            print(json.dumps(rows[-1]), flush=True)
            del xr, xi, yr, yi, y, ref
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
