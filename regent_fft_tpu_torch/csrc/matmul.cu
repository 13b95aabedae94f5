// Matmul-form DFT kernels for Hopper (sm_90a) on split re/im f32 planes:
//
//   fft_mm1_kernel  replaces regent_fft_tpu/ops/pallas_fft.py:_runner_1stage
//   fft_mm2_kernel  replaces regent_fft_tpu/ops/pallas_fft.py:_runner_2stage
//
// fft_mm1: y = x . D_n on (B, n) rows, n <= 128, D_n[j, k] = W_n^{j*k}.
// fft_mm2: the fused two-stage four-step on (B, n) rows, n = n1 * n2: the row
// viewed as X[nu1][nu2] (nu = nu1 * n2 + nu2), A[k1][nu2] = sum_nu1
// X[nu1][nu2] W_n1^{nu1*k1}, times the twiddle W_n^{nu2*k1}, then C[k1][k2] =
// sum_nu2 A[k1][nu2] W_n2^{nu2*k2}, written to y[k1 + n1 * k2].
//
// Bound on H100: operations.  These are dense products, 8*n^2 flops per row
// for fft_mm1 and 8*n*(n1 + n2) + 6*n for fft_mm2 (the TPU CostEstimates),
// 390-1024 flops per complex element at the main path's lengths against the
// 16 B the element moves: 24-64 flop/B, above the FP32 ridge of 20 (67
// TFLOP/s over 3.35 TB/s).  The TPU ran them on the MXU at the plan's
// precision; the JAX plan asks for HIGHEST, so these run exact f32 FFMA (no
// TF32; tensor-core splits, 3xTF32 or bf16x3, are later work).
//
// Design.  A block takes R whole rows (R from n: about 4096 complex elements
// a block, fewer where a thread would hold more than 8 outputs) into shared
// memory as (re, im) pairs, coalesced, and masks the ragged last block
// instead of padding the batch.  The TPU kernel holds the whole n x n matrix
// in VMEM; here the n roots W_n^e (e = 0..n-1, from a float64 host table,
// rounded once to f32) sit in shared memory and D_n[j, k] is read as root
// (j*k) mod n: the same values bit for bit in 8*n bytes.  A contraction
// (dft_column) gives each thread one column of the tile and up to MAXO of
// its outputs k; the lanes of a warp take neighbouring columns, so the data
// reads hit distinct banks (rows are an odd number of pairs apart) and the
// root reads are mostly one broadcast address.  Every thread reads all its
// inputs before the block synchronises and writes its outputs in place.
// fft_mm2's twiddle is root nu2*k1 < n of W_n, read from the device table
// through the read-only cache; its output goes to shared memory in output
// order and leaves coalesced, not by a strided scatter.
//
// Resident blocks (512 threads each): MAXO = 8 instances are built for two
// blocks an SM (at most 64 registers); n = 1024 (32 x 32) takes R = 4 rows
// and 34 KB of shared memory.  n = 16384 (128 x 128) takes one row of
// 132 KB, MAXO = 32, one block an SM.
//
// Conventions: kernels launch on the caller's stream, never synchronise and
// allocate nothing; each C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include <cuda_runtime.h>

namespace {

constexpr int MM_THREADS = 512;
constexpr int MM_BLOCK_ELEMS = 4096;   // target complex elements a block
constexpr int MM_MAX_N = 128;          // largest DFT length of one stage
constexpr size_t MM_SMEM_MAX = 232448; // 227 KB, the per-block limit

// The thread's share of a contraction over `ncols` columns of L-point
// sequences: column c, outputs k = k0 + G * i for i < ot.
struct Share {
  int c, k0, G, ot;
};

__host__ __device__ inline int outputs_per_thread(int ncols, int L) {
  const int G = MM_THREADS / ncols;
  return (L + G - 1) / G;
}

__device__ __forceinline__ Share share(int ncols, int L) {
  Share s;
  s.G = MM_THREADS / ncols;
  s.c = threadIdx.x % ncols;
  s.k0 = threadIdx.x / ncols;
  s.ot = (s.k0 < s.G && s.k0 < L) ? (L - 1 - s.k0) / s.G + 1 : 0;
  return s;
}

// acc[i] = sum_j x[j] * w[(j * k_i) mod L], k_i = sh.k0 + sh.G * i, for one
// column whose element j lies at s[base + j * js]; w holds the L roots.
// The exponents are carried mod L by additions (no division in the loop).
template <int MAXO>
__device__ __forceinline__ void dft_column(const float2* s, int base, int js,
                                           const float2* w, int L,
                                           const Share& sh,
                                           float2 (&acc)[MAXO]) {
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = make_float2(0.0f, 0.0f);
  const int g = sh.G % L;
  int e0 = 0;   // j * k0 mod L
  int d = 0;    // j * G mod L
  for (int j = 0; j < L; ++j) {
    const float2 x = s[base + j * js];
    int e = e0;
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      if (i < sh.ot) {
        const float2 r = w[e];
        acc[i].x = fmaf(x.x, r.x, fmaf(-x.y, r.y, acc[i].x));
        acc[i].y = fmaf(x.x, r.y, fmaf(x.y, r.x, acc[i].y));
        e += d;
        if (e >= L) e -= L;
      }
    }
    e0 += sh.k0;
    if (e0 >= L) e0 -= L;
    d += g;
    if (d >= L) d -= L;
  }
}

// --------------------------------------------------------------------------
// fft_mm1_kernel — replaces pallas_fft.py:_runner_1stage (direct DFT of
// (B, n) rows).  Block: R rows, row r at s[r * (n | 1)]; the contraction's
// columns are the rows.
// --------------------------------------------------------------------------
template <int MAXO>
__global__ void __launch_bounds__(MM_THREADS, MAXO <= 8 ? 2 : 1)
fft_mm1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, long long B,
               int n, int R, const float2* __restrict__ roots) {
  extern __shared__ float2 smem[];
  const int pitch = n | 1;
  float2* s = smem;
  float2* w = smem + R * pitch;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)(B - row0 < R ? B - row0 : R);
  const size_t g0 = (size_t)row0 * n;
  for (int q = threadIdx.x; q < n; q += MM_THREADS) w[q] = roots[q];
  for (int q = threadIdx.x; q < rows * n; q += MM_THREADS) {
    const int r = q / n;
    s[r * pitch + q - r * n] = make_float2(xr[g0 + q], xi[g0 + q]);
  }
  __syncthreads();
  const Share sh = share(R, n);
  const bool active = sh.ot > 0 && sh.c < rows;
  float2 acc[MAXO];
  if (active) dft_column<MAXO>(s, sh.c * pitch, 1, w, n, sh, acc);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < MAXO; ++i)
      if (i < sh.ot) s[sh.c * pitch + sh.k0 + sh.G * i] = acc[i];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < rows * n; q += MM_THREADS) {
    const int r = q / n;
    const float2 v = s[r * pitch + q - r * n];
    yr[g0 + q] = v.x;
    yi[g0 + q] = v.y;
  }
}

// --------------------------------------------------------------------------
// fft_mm2_kernel — replaces pallas_fft.py:_runner_2stage (two-stage
// four-step of (B, n1 * n2) rows).  Block: R rows, row r's X[nu1][nu2] at
// s[r * n1 * p2 + nu1 * p2 + nu2] with p2 = n2 | 1.  Stage 1 contracts the
// columns (r, nu2) over nu1 in place (A[k1][nu2] where X[k1][nu2] was),
// stage 2 the columns (r, k1) over nu2, writing C[k1][k2] at
// r * n1 * p2 + k1 + n1 * k2, the output order.  `tables`: the n1 roots of
// W_n1, the n2 of W_n2, the n of W_n.
// --------------------------------------------------------------------------
template <int MAXO>
__global__ void __launch_bounds__(MM_THREADS, MAXO <= 8 ? 2 : 1)
fft_mm2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, long long B,
               int n1, int n2, int R, const float2* __restrict__ tables) {
  extern __shared__ float2 smem[];
  const int n = n1 * n2;
  const int p2 = n2 | 1;
  const int rs = n1 * p2;
  float2* s = smem;
  float2* w1 = smem + R * rs;
  float2* w2 = w1 + n1;
  const float2* __restrict__ tw = tables + n1 + n2;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)(B - row0 < R ? B - row0 : R);
  const size_t g0 = (size_t)row0 * n;
  for (int q = threadIdx.x; q < n1 + n2; q += MM_THREADS) w1[q] = tables[q];
  for (int q = threadIdx.x; q < rows * n; q += MM_THREADS) {
    const int r = q / n;
    const int nu = q - r * n;
    const int nu1 = nu / n2;
    s[r * rs + nu1 * p2 + nu - nu1 * n2] = make_float2(xr[g0 + q], xi[g0 + q]);
  }
  __syncthreads();
  {  // stage 1: D_n1 over nu1, then the twiddle
    const Share sh = share(R * n2, n1);
    const int r = sh.c / n2;
    const int nu2 = sh.c - r * n2;
    const int base = r * rs + nu2;
    const bool active = sh.ot > 0 && r < rows;
    float2 acc[MAXO];
    if (active) dft_column<MAXO>(s, base, p2, w1, n1, sh, acc);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < MAXO; ++i) {
        if (i < sh.ot) {
          const int k1 = sh.k0 + sh.G * i;
          const float2 t = __ldg(&tw[nu2 * k1]);
          const float2 a = acc[i];
          s[base + k1 * p2] = make_float2(fmaf(a.x, t.x, -a.y * t.y),
                                          fmaf(a.x, t.y, a.y * t.x));
        }
      }
    }
    __syncthreads();
  }
  {  // stage 2: D_n2 over nu2, into output order
    const Share sh = share(R * n1, n2);
    const int r = sh.c / n1;
    const int k1 = sh.c - r * n1;
    const bool active = sh.ot > 0 && r < rows;
    float2 acc[MAXO];
    if (active) dft_column<MAXO>(s, r * rs + k1 * p2, 1, w2, n2, sh, acc);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < MAXO; ++i)
        if (i < sh.ot) s[r * rs + k1 + n1 * (sh.k0 + sh.G * i)] = acc[i];
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < rows * n; q += MM_THREADS) {
    const int r = q / n;
    const float2 v = s[r * rs + q - r * n];
    yr[g0 + q] = v.x;
    yi[g0 + q] = v.y;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int MAXO>
cudaError_t launch_mm2(const float* xr, const float* xi, float* yr, float* yi,
                       long long B, int n1, int n2, int R,
                       const float2* tables, cudaStream_t stream) {
  const size_t smem =
      sizeof(float2) * ((size_t)R * n1 * (n2 | 1) + n1 + n2);
  if (smem > MM_SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = set_smem((const void*)fft_mm2_kernel<MAXO>, smem);
  if (e != cudaSuccess) return e;
  const long long grid = (B + R - 1) / R;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  fft_mm2_kernel<MAXO><<<(unsigned)grid, MM_THREADS, smem, stream>>>(
      xr, xi, yr, yi, B, n1, n2, R, tables);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Direct DFT of (B, n) f32 rows, 1 <= n <= 128; `roots`: the n roots
// exp(sign*2*pi*i*e/n) as (re, im) pairs.
int fft_mm1(const float* xr, const float* xi, float* yr, float* yi,
            long long B, int n, const float2* roots, void* stream) {
  if (n < 1 || n > MM_MAX_N) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  int R = MM_BLOCK_ELEMS / n;
  if (R > MM_THREADS) R = MM_THREADS;
  while (R > 1 && outputs_per_thread(R, n) > 8) --R;
  const size_t smem = sizeof(float2) * ((size_t)R * (n | 1) + n);
  cudaError_t e = set_smem((const void*)fft_mm1_kernel<8>, smem);
  if (e != cudaSuccess) return e;
  const long long grid = (B + R - 1) / R;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  fft_mm1_kernel<8><<<(unsigned)grid, MM_THREADS, smem,
                      (cudaStream_t)stream>>>(xr, xi, yr, yi, B, n, R, roots);
  return cudaGetLastError();
}

// Two-stage four-step of (B, n1 * n2) f32 rows, 2 <= n_i <= 128, output
// index k1 + n1 * k2; `tables`: the roots of n1, then of n2, then of
// n1 * n2, each exp(sign*2*pi*i*e/m) as (re, im) pairs.
int fft_mm2(const float* xr, const float* xi, float* yr, float* yi,
            long long B, int n1, int n2, const float2* tables, void* stream) {
  if (n1 < 2 || n1 > MM_MAX_N || n2 < 2 || n2 > MM_MAX_N)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int n = n1 * n2;
  int R = n < MM_BLOCK_ELEMS ? MM_BLOCK_ELEMS / n : 1;
  auto most = [&](int r) {
    const int a = outputs_per_thread(r * n2, n1);
    const int b = outputs_per_thread(r * n1, n2);
    return a > b ? a : b;
  };
  // every column of both stages needs a thread; at most 8 outputs each
  while (R > 1 && (R * n1 > MM_THREADS || R * n2 > MM_THREADS || most(R) > 8))
    --R;
  const int ot = most(R);
  cudaStream_t st = (cudaStream_t)stream;
  if (ot <= 8) return launch_mm2<8>(xr, xi, yr, yi, B, n1, n2, R, tables, st);
  if (ot <= 16) return launch_mm2<16>(xr, xi, yr, yi, B, n1, n2, R, tables, st);
  if (ot <= 32) return launch_mm2<32>(xr, xi, yr, yi, B, n1, n2, R, tables, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
