// What every butterfly kernel for Hopper (sm_90a) shares: the stage plan
// of the cluster kernels (StagePlan, make_plan: fft_fused2 and the gap pass
// in stockham.cu, the fuse_last ring in ring.cu), the in-register R-point
// DFTs of radix 2, 3, 4, 5 and 7 (radix.cuh adds 8 and 16), the element
// conversions between the plane types and f32, and the dynamic shared
// memory opt-in.  The register-resident bodies that run them are in
// last.cuh (rows), cols.cuh (columns) and fused2.cuh (a cluster-resident
// plane).  Everything here has internal linkage, so each translation unit
// carries its own copy and the library needs no -rdc.
//
// Arithmetic is exact f32 (no TF32, no fast-math intrinsics).  Twiddles come
// from host tables generated in float64 and rounded once to f32
// (regent_fft_tpu_torch/ops/stockham_kernels.py:_stage_tables, from the
// stage lists of the same module), so Python is the single source of truth
// for the schedule and the kernels only validate it.
//
// Stage (radix R, Ns = product of the radices before it, m = n/R), for each
// butterfly j in [0, m):
//     v[r]  = x[j + r*m] * W_{Ns*R}^{r*(j mod Ns)}        r = 0..R-1
//     y     = DFT_R(v)
//     out[(j - j mod Ns)*R + j mod Ns + r*Ns] = y[r]
// (Stockham autosort, decimation in time: natural order in and out.)  The
// odd radix runs last, so every Ns is a power of two.
//
// Conventions: kernels launch on the caller's stream, never synchronise and
// allocate nothing; each C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for a schedule it does not accept).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STAGES = 12;

struct StagePlan {
  int n;
  int nstages;
  int radix[MAX_STAGES];
  int lns[MAX_STAGES];     // log2(Ns) of each stage
  int twoff[MAX_STAGES];   // offset of the stage's (R-1)*Ns twiddles
};

inline int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// cos/sin(2*pi*m/R) for the odd radices, rounded from float64.
__constant__ float kCos3[3] = {1.0f, -0.5f, -0.5f};
__constant__ float kSin3[3] = {0.0f, 0.8660254037844386f, -0.8660254037844386f};
__constant__ float kCos5[5] = {1.0f, 0.30901699437494745f, -0.8090169943749473f,
                               -0.8090169943749476f, 0.30901699437494723f};
__constant__ float kSin5[5] = {0.0f, 0.9510565162951535f, 0.5877852522924732f,
                               -0.587785252292473f, -0.9510565162951536f};
__constant__ float kCos7[7] = {1.0f, 0.6234898018587336f, -0.22252093395631434f,
                               -0.900968867902419f, -0.9009688679024191f,
                               -0.2225209339563146f, 0.6234898018587334f};
__constant__ float kSin7[7] = {0.0f, 0.7818314824680298f, 0.9749279121818236f,
                               0.43388373911755823f, -0.433883739117558f,
                               -0.9749279121818236f, -0.7818314824680299f};

template <int R> __device__ __forceinline__ float rcos(int m);
template <int R> __device__ __forceinline__ float rsin(int m);
template <> __device__ __forceinline__ float rcos<3>(int m) { return kCos3[m]; }
template <> __device__ __forceinline__ float rsin<3>(int m) { return kSin3[m]; }
template <> __device__ __forceinline__ float rcos<5>(int m) { return kCos5[m]; }
template <> __device__ __forceinline__ float rsin<5>(int m) { return kSin5[m]; }
template <> __device__ __forceinline__ float rcos<7>(int m) { return kCos7[m]; }
template <> __device__ __forceinline__ float rsin<7>(int m) { return kSin7[m]; }

// In-register R-point DFT, y[k] = sum_r v[r] * exp(s*2*pi*i*r*k/R).
template <int R>
struct Dft {
  __device__ __forceinline__ static void run(float* vr, float* vi, float s) {
    float yr[R], yi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      yr[k] = vr[0];
      yi[k] = vi[0];
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const float c = rcos<R>((m * k) % R);
        const float sn = s * rsin<R>((m * k) % R);
        yr[k] = fmaf(vr[m], c, fmaf(-vi[m], sn, yr[k]));
        yi[k] = fmaf(vr[m], sn, fmaf(vi[m], c, yi[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      vr[k] = yr[k];
      vi[k] = yi[k];
    }
  }
};

template <>
struct Dft<2> {
  __device__ __forceinline__ static void run(float* vr, float* vi, float) {
    const float ar = vr[0] + vr[1], ai = vi[0] + vi[1];
    vr[1] = vr[0] - vr[1];
    vi[1] = vi[0] - vi[1];
    vr[0] = ar;
    vi[0] = ai;
  }
};

// The radix-4 butterfly of pallas_stockham.py:_bfly_core.
template <>
struct Dft<4> {
  __device__ __forceinline__ static void run(float* vr, float* vi, float s) {
    const float t0r = vr[0] + vr[2], t0i = vi[0] + vi[2];
    const float t1r = vr[0] - vr[2], t1i = vi[0] - vi[2];
    const float t2r = vr[1] + vr[3], t2i = vi[1] + vi[3];
    const float t3r = vr[1] - vr[3], t3i = vi[1] - vi[3];
    const float it3r = -s * t3i, it3i = s * t3r;
    vr[0] = t0r + t2r;
    vi[0] = t0i + t2i;
    vr[1] = t1r + it3r;
    vi[1] = t1i + it3i;
    vr[2] = t0r - t2r;
    vi[2] = t0i - t2i;
    vr[3] = t1r - it3r;
    vi[3] = t1i - it3i;
  }
};

// Element conversions between the plane types and f32 (a bf16 output is
// rounded to nearest even).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Validate a stage list from the host and fill the plan of a cluster
// kernel (fused2.cuh).  Radices must be 2, 3, 4, 5, 7 or 8, multiply to n,
// and every Ns must be a power of two.
int make_plan(int n, int nstages, const int* radices, StagePlan* p) {
  if (n < 2 || nstages < 1 || nstages > MAX_STAGES) return 1;
  p->n = n;
  p->nstages = nstages;
  int ns = 1, off = 0;
  for (int i = 0; i < nstages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8) return 1;
    if (ns & (ns - 1)) return 1;
    p->radix[i] = r;
    p->lns[i] = ilog2(ns);
    p->twoff[i] = off;
    off += (r - 1) * ns;
    ns *= r;
  }
  return ns == n ? 0 : 1;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
