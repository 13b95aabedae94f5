#!/usr/bin/env python3
"""Time ``fft_mm1``/``fft_mm2`` and the ``backend="pallas"`` plans that run
them, for the ``regent_fft_tpu_torch`` package of the directory it is run
from.

    python3 scripts/torch_mm_compare.py [label] [--mma-rate]

Run it from the root of two checkouts (say a commit and its parent) in one
run on one GPU to compare them.  Prints the card's name and power limit,
then one JSON line: the kernels' ms (median of 10 CUDA-event runs, L2
flushed before each) at 262144 x 128 (fft_mm1), 4096 x 1024, 4096 x 640,
262144 x 256 and 262144 x 512 (fft_mm2), and the complex64 pallas plans'
ms at 4096 x 1024 (axis 1), 16 x 128^3 (axes 1-3) and 512^3.  With
``--mma-rate`` it also builds (nvcc, into ``build/``) and times a kernel
that only issues ``mma.sync.m16n8k8`` TF32 products with f32 accumulation,
eight independent chains a warp, and prints its TFLOP/s: the rate the
matmul kernels' products can reach on this card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import regent_fft_tpu_torch as rt                        # noqa: E402
from regent_fft_tpu_torch.ops import pallas_fft as pf    # noqa: E402

KERNEL_SHAPES = [(262144, 128), (4096, 1024), (4096, 640), (262144, 256),
                 (262144, 512)]
PLANS = [((4096, 1024), (1,)), ((16, 128, 128, 128), (1, 2, 3)),
         ((512, 512, 512), (0, 1, 2))]

MMA_SRC = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  float acc[8][4] = {};
  const uint32_t a0 = seed, a1 = seed ^ 1u, a2 = seed ^ 2u, a3 = seed ^ 3u;
  const uint32_t b0 = seed ^ 4u, b1 = seed ^ 5u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1234.5f) out[0] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* o;
  cudaMalloc(&o, 4);
  const int iters = 20000, threads = 256;
  mma_loop<<<sms, threads>>>(o, 10, 0x3f800000u);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  mma_loop<<<sms, threads>>>(o, iters, 0x3f800000u);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * 16 * 8 * 8 * iters * 8.0 * sms * (threads / 32);
  printf("%.6f\n", flops / ms / 1e9);
  return cudaGetLastError() != cudaSuccess;
}
"""


def mma_rate() -> float:
    """TFLOP/s of a kernel that issues only TF32 mma.sync products."""
    out = os.path.join(os.getcwd(), "build", "mma_rate")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = out + ".cu"
    with open(src, "w") as f:
        f.write(MMA_SRC)
    nvcc = "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc if os.path.exists(nvcc) else "nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", out, src],
                   check=True, timeout=300)
    r = subprocess.run([out], capture_output=True, text=True, check=True,
                       timeout=120)
    return float(r.stdout.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mm_compare: no CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

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

    res = {"label": args[0] if args else os.getcwd(), "kernels_ms": {},
           "plans_ms": {}}
    for b, n in KERNEL_SHAPES:
        xr = torch.randn((b, n), device=dev, generator=gen)
        xi = torch.randn((b, n), device=dev, generator=gen)
        if n <= 128:
            name, fn = "fft_mm1", lambda: pf.fft_mm1(xr, xi, n, -1)
        else:
            n1, n2 = pf.two_stage_split(n)
            name, fn = "fft_mm2", lambda: pf.fft_mm2(xr, xi, n1, n2, -1)
        res["kernels_ms"][f"{name} {b}x{n}"] = timed(fn)
        del xr, xi
    for shape, axes in PLANS:
        p = rt.make_plan(shape, axes=axes, backend="pallas")
        x = torch.complex(torch.randn(shape, device=dev, generator=gen),
                          torch.randn(shape, device=dev, generator=gen))
        res["plans_ms"]["x".join(map(str, shape))] = timed(lambda: p(x))
        del x
        torch.cuda.empty_cache()
    if "--mma-rate" in sys.argv:
        res["mma_sync_tf32_tflops"] = mma_rate()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
