// The shared-memory Stockham tile of the Hopper (sm_90a) FFT kernels:
// split re/im planes, one routine (fft_tile) that transforms `nt`
// independent n-point sequences held in dynamic shared memory as f32, and
// the column pass that loads a tile from global memory, transforms it and
// writes it back (optionally to another layout, with the four-step twiddle
// on the write).  The pass is a template on the element types it loads and
// stores: f32 planes (complex64) or bf16 planes
// (complex32, converted to f32 on load and rounded to nearest even on the
// store, the scale applied in f32 first); the tile itself is f32 either
// way.  The column pass runs fft_cols_tw (stockham.cu) and the leading-axis
// four-step stages (fourstep.cu); every butterfly kernel includes this
// header for the stage plan, the radix DFTs and the element conversions.
// Everything here has internal linkage, so each translation unit carries
// its own copy and the library needs no -rdc.
//
// What is ported is what the TPU tile computes (pallas_stockham.py:
// _stockham_tile), not its block structure.  The TPU tile runs radix-4
// head stages and finishes with a dense mt-point DFT on the MXU; here every
// stage is an FFMA butterfly (radix 4, one radix-2 stage when log2 of the
// power-of-two part is odd, and one radix-3/5/7 stage for the mixed-radix
// lengths mt*4^s), since a dense tail in FFMA costs ~8*mt flops per element.
//
// Arithmetic is exact f32 (no TF32, no fast-math intrinsics).  Twiddles come
// from a host table generated in float64 and rounded once to f32
// (regent_fft_tpu_torch/ops/stockham_kernels.py:_kernel_tables); the stage
// list comes from the same module (_kernel_stages), so Python is the single
// source of truth for the schedule and this file only validates it.
//
// Stage (radix R, Ns = product of the radices before it, m = n/R), for each
// butterfly j in [0, m):
//     v[r]  = x[j + r*m] * W_{Ns*R}^{r*(j mod Ns)}        r = 0..R-1
//     y     = DFT_R(v)
//     out[(j - j mod Ns)*R + j mod Ns + r*Ns] = y[r]
// (Stockham autosort, decimation in time: natural order in and out.)  The
// odd radix runs last, so every Ns is a power of two.
//
// A stage runs in place in one shared buffer: every thread first reads all
// of its butterflies' inputs into registers, the block synchronises, then
// every thread writes its outputs.  Each thread owns at most ELEMS values of
// a transform, so the register arrays have compile-time sizes.
//
// Conventions: kernels launch on the caller's stream, never synchronise and
// allocate nothing; each C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for a schedule it does not accept).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;     // threads per block, every kernel
constexpr int ELEMS = 16;        // values of one transform a thread holds
constexpr int MAX_STAGES = 12;

struct StagePlan {
  int n;
  int nstages;
  int radix[MAX_STAGES];
  int lns[MAX_STAGES];     // log2(Ns) of each stage
  int twoff[MAX_STAGES];   // offset of the stage's (R-1)*Ns twiddles
};

// Tile geometry: `tj` threads per transform, `nt` transforms per tile
// (tj * nt == THREADS).
struct Geo {
  int tj;
  int nt;
  int lnt;
};

__host__ __device__ inline int pow2ceil(int x) {
  int v = 1;
  while (v < x) v <<= 1;
  return v;
}

__host__ __device__ inline int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Column tiles: element (t, j) at j*nt + t, so neighbouring threads take
// neighbouring columns (coalesced global loads along the contiguous axis).
__host__ __device__ inline Geo cols_geo(int n) {
  Geo g;
  g.tj = pow2ceil((n + ELEMS - 1) / ELEMS);
  g.nt = THREADS / g.tj;
  g.lnt = ilog2(g.nt);
  return g;
}

inline size_t cols_smem_bytes(int n) {
  return 2 * sizeof(float) * (size_t)n * cols_geo(n).nt;
}

__device__ __forceinline__ int at(int t, int j, const Geo& g) {
  return j * g.nt + t;
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

// One in-place Stockham stage over the tile.  (t, jl) is this thread's
// transform and its lane within the transform.
template <int R>
__device__ __forceinline__ void stage(float* sr, float* si, int m, int lns,
                                      const float2* __restrict__ tw, float s,
                                      int t, int jl, const Geo& g) {
  constexpr int MAXB = (ELEMS + R - 1) / R;
  float vr[MAXB][R], vi[MAXB][R];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    const int j = jl + b * g.tj;
    if (j < m) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = at(t, j + r * m, g);
        vr[b][r] = sr[a];
        vi[b][r] = si[a];
      }
    }
  }
  __syncthreads();
  const int ns = 1 << lns;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    const int j = jl + b * g.tj;
    if (j < m) {
      const int k = j & (ns - 1);
      if (lns) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 w = __ldg(&tw[(r - 1) * ns + k]);
          const float xr = vr[b][r], xi = vi[b][r];
          vr[b][r] = fmaf(xr, w.x, -xi * w.y);
          vi[b][r] = fmaf(xr, w.y, xi * w.x);
        }
      }
      Dft<R>::run(vr[b], vi[b], s);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = at(t, base + r * ns, g);
        sr[a] = vr[b][r];
        si[a] = vi[b][r];
      }
    }
  }
  __syncthreads();
}

// The shared tile routine: all stages of an n-point transform on every
// transform of the tile.  Must be entered after a __syncthreads() that
// follows the tile load; returns after one that follows the last stage.
__device__ void fft_tile(float* sr, float* si, const StagePlan& p,
                         const float2* __restrict__ tw, float s, int t, int jl,
                         const Geo& g) {
  for (int st = 0; st < p.nstages; ++st) {
    const int r = p.radix[st];
    const int m = p.n / r;
    const float2* tws = tw + p.twoff[st];
    const int lns = p.lns[st];
    switch (r) {
      case 2: stage<2>(sr, si, m, lns, tws, s, t, jl, g); break;
      case 3: stage<3>(sr, si, m, lns, tws, s, t, jl, g); break;
      case 4: stage<4>(sr, si, m, lns, tws, s, t, jl, g); break;
      case 5: stage<5>(sr, si, m, lns, tws, s, t, jl, g); break;
      default: stage<7>(sr, si, m, lns, tws, s, t, jl, g); break;
    }
  }
}

// Element conversions of the passes.  Global accesses stay scalar (one
// element a thread, neighbouring threads on neighbouring addresses), so a
// 2-byte bf16 element needs no alignment beyond its own.
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

// exp(s * 2*pi*i * e / 2^lN) for 0 <= e < 2^lN <= 2^24.  The phase index e
// is an exact integer and 2e/N is exact in f32 (N a power of two), so the
// only rounding is sincospif's own.
__device__ __forceinline__ float2 twiddle_pow2(int e, int lN, float s) {
  float sn, cs;
  sincospif(ldexpf((float)e, 1 - lN), &sn, &cs);
  return make_float2(cs, s * sn);
}

// Where a column pass writes: element (k, c) of the transformed tile goes to
// y[k * stride + c], times scale and, when lN > 0, the four-step twiddle
// W_N^{k * (c / tdiv)} with N = 2^lN (the caller keeps k * (c / tdiv) < N).
struct ColsOut {
  long long stride;
  int lN;
  int tdiv;
};

// Columns [c0, c0 + nt) of an (n, V) plane pair -> transformed along n,
// written as `out` says.  Columns at or past V are masked.
template <typename TI, typename TO>
__device__ void cols_pass(const TI* xr, const TI* xi, TO* yr, TO* yi,
                          int c0, int V, const StagePlan& p,
                          const float2* __restrict__ tw, float s, float scale,
                          float* sr, float* si, const ColsOut& out) {
  const Geo g = cols_geo(p.n);
  const int n = p.n;
  const int t = threadIdx.x & (g.nt - 1);
  const int jl = threadIdx.x >> g.lnt;
  const int c = c0 + t;
  const bool valid = c < V;
  for (int j = jl; j < n; j += g.tj) {
    const int a = at(t, j, g);
    const size_t o = (size_t)j * V + c;
    sr[a] = valid ? to_f32(xr[o]) : 0.0f;
    si[a] = valid ? to_f32(xi[o]) : 0.0f;
  }
  __syncthreads();
  fft_tile(sr, si, p, tw, s, t, jl, g);
  if (valid) {
    const int b = out.lN ? c / out.tdiv : 0;
    for (int j = jl; j < n; j += g.tj) {
      const int a = at(t, j, g);
      float vr = sr[a] * scale, vi = si[a] * scale;
      if (out.lN) {
        const float2 w = twiddle_pow2(j * b, out.lN, s);
        const float ur = vr;
        vr = fmaf(ur, w.x, -vi * w.y);
        vi = fmaf(ur, w.y, vi * w.x);
      }
      const size_t o = (size_t)j * out.stride + c;
      yr[o] = from_f32<TO>(vr);
      yi[o] = from_f32<TO>(vi);
    }
  }
  __syncthreads();
}

// The plain column pass over an (n, V) plane: the output has the input's
// layout, no twiddle.
template <typename TI, typename TO>
__device__ __forceinline__ void cols_pass(const TI* xr, const TI* xi,
                                          TO* yr, TO* yi, int c0, int V,
                                          const StagePlan& p,
                                          const float2* __restrict__ tw,
                                          float s, float scale, float* sr,
                                          float* si) {
  cols_pass(xr, xi, yr, yi, c0, V, p, tw, s, scale, sr, si,
            ColsOut{V, 0, 1});
}

// Validate a stage list from the host and fill the plan.  Radices must be
// 2, 3, 4, 5 or 7 (also 8 when `wide`, for the cluster kernel of
// stockham.cu), multiply to n, and every Ns must be a power of two.
int make_plan(int n, int nstages, const int* radices, StagePlan* p,
              bool wide = false) {
  if (n < 2 || nstages < 1 || nstages > MAX_STAGES) return 1;
  p->n = n;
  p->nstages = nstages;
  int ns = 1, off = 0;
  for (int i = 0; i < nstages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7
        && !(wide && r == 8))
      return 1;
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
