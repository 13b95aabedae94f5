// The two-pass leading-axis four-step for Hopper (sm_90a) on split re/im
// planes: f32 (complex64) or bf16 (complex32):
//
//   a0fs_a_kernel<T>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_a0fs, stage "a"
//   a0fs_b_kernel<T>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_a0fs, stage "b"
//
// An FFT of length n = r1 * r2 along a leading or middle axis of a
// (pre, n, post) array, input index j = a * r2 + b:
//
//   stage a: for each (p, b, column) the r1-point DFT over a (rows r2 apart),
//            times W_n^{k1 * b}, written back to row k1 * r2 + b;
//   stage b: for each (p, k1, column) the r2-point DFT over b (a contiguous
//            group of r2 rows), scaled, written to row k2 * r1 + k1, so the
//            output index k = k1 + r1 * k2 comes out in natural order.
//
// Bound on H100: bytes.  Each stage reads and writes every complex element
// once (16 B); together 32 B per element against the single-pass kernels'
// 16 B.  The TPU kernel contracts each slab with a dense (r, r) matrix on the
// MXU ('h4', the twiddle folded into the stage-a matrices).  A dense r-point
// DFT in FFMA costs 8r flops per element: 256 flops per 16 B at r = 32,
// 16 flop/B against the FP32 ridge of 20 flop/B, and past it at r = 64.  So
// each stage here runs the shared tile's butterflies over r (~5*log2(r)
// flops per element) and forms the stage-a twiddle on the write from the
// exact integer phase index k1 * b < n (stockham_tile.cuh: twiddle_pow2).
// A block takes an (r, nt) slab: nt = 512 columns at r = 16, 256 at r = 32,
// so every row of the slab is a contiguous run of 1-2 KiB along `post`.
// The TPU kernel's slab rows and DMA ring depth are VMEM choices; here two
// blocks per SM overlap one slab's loads with the other's butterflies.
//
// The bf16 instances (C entries a0fs_a_bf16, a0fs_b_bf16) replace the
// stages with io="bf16", which the TPU runs as 'hd' dots (_dg0_3m: one
// native bf16 MXU pass per dot, the stage matrices rounded to bf16).  Here
// they are the same f32 butterfly tile between bf16 loads and stores (the
// column pass's element types), the stage-a twiddle still formed from the
// exact integer phase: at least as accurate as 'hd', whose tables carry a
// bf16 rounding.  The intermediate between the stages is bf16, as in the
// JAX package.  Bound: bytes, 8 B per complex element per stage.

#include "stockham_tile.cuh"

namespace {

// Stage a over the (pre, r1, V = r2 * post) view: the column pass of the
// r1-point DFT, in place in the output's layout, with W_n^{k1 * (c / post)}.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
a0fs_a_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
              T* __restrict__ yr, T* __restrict__ yi, int V, int ntiles,
              int post, int lN, StagePlan p, const float2* __restrict__ tw,
              float s) {
  extern __shared__ float smem[];
  const Geo g = cols_geo(p.n);
  float* sr = smem;
  float* si = smem + p.n * g.nt;
  const long long pre = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * g.nt;
  const size_t base = (size_t)pre * p.n * V;
  cols_pass(xr + base, xi + base, yr + base, yi + base, c0, V, p, tw, s,
            1.0f, sr, si, ColsOut{V, lN, post});
}

// Stage b over the (pre * r1, r2, post) view: the column pass of the r2-point
// DFT of group q = p * r1 + k1, written to rows (p * n + k2 * r1 + k1).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
a0fs_b_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
              T* __restrict__ yr, T* __restrict__ yi, int post, int ntiles,
              int r1, StagePlan p, const float2* __restrict__ tw, float s,
              float scale) {
  extern __shared__ float smem[];
  const Geo g = cols_geo(p.n);
  float* sr = smem;
  float* si = smem + p.n * g.nt;
  const long long q = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * g.nt;
  const size_t ibase = (size_t)q * p.n * post;
  const long long grp = q / r1, k1 = q - grp * r1;
  const size_t obase = ((size_t)grp * r1 * p.n + k1) * post;
  cols_pass(xr + ibase, xi + ibase, yr + obase, yi + obase, c0, post, p, tw,
            s, scale, sr, si, ColsOut{(long long)r1 * post, 0, 1});
}

template <typename T>
cudaError_t launch_a(const T* xr, const T* xi, T* yr, T* yi, long long pre,
                     int r1, int r2, long long post, int sign,
                     const float2* tw, int nstages, const int* radices,
                     void* stream) {
  StagePlan p;
  if (make_plan(r1, nstages, radices, &p)) return cudaErrorInvalidValue;
  const long long n = (long long)r1 * r2, V = r2 * post;
  if (r2 < 1 || post < 1 || V > (1LL << 30) || (n & (n - 1)) || n > (1 << 24))
    return cudaErrorInvalidValue;
  if (pre <= 0) return cudaSuccess;
  const size_t smem = cols_smem_bytes(r1);
  cudaError_t e = set_smem((const void*)a0fs_a_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int nt = cols_geo(r1).nt;
  const int ntiles = (int)((V + nt - 1) / nt);
  a0fs_a_kernel<T><<<(unsigned)(pre * ntiles), THREADS, smem,
                     (cudaStream_t)stream>>>(xr, xi, yr, yi, (int)V, ntiles,
                                             (int)post, ilog2((int)n), p, tw,
                                             (float)sign);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_b(const T* xr, const T* xi, T* yr, T* yi, long long pre,
                     int r1, int r2, long long post, int sign, float scale,
                     const float2* tw, int nstages, const int* radices,
                     void* stream) {
  StagePlan p;
  if (make_plan(r2, nstages, radices, &p)) return cudaErrorInvalidValue;
  if (r1 < 1 || post < 1 || post > (1LL << 30)) return cudaErrorInvalidValue;
  if (pre <= 0) return cudaSuccess;
  const size_t smem = cols_smem_bytes(r2);
  cudaError_t e = set_smem((const void*)a0fs_b_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int nt = cols_geo(r2).nt;
  const int ntiles = (int)((post + nt - 1) / nt);
  a0fs_b_kernel<T><<<(unsigned)(pre * r1 * ntiles), THREADS, smem,
                     (cudaStream_t)stream>>>(xr, xi, yr, yi, (int)post, ntiles,
                                             r1, p, tw, (float)sign, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Stage a of the leading-axis four-step over (pre, r1 * r2, post) planes;
// radices/tw describe the r1-point transform.
int a0fs_a(const float* xr, const float* xi, float* yr, float* yi,
           long long pre, int r1, int r2, long long post, int sign,
           const float2* tw, int nstages, const int* radices, void* stream) {
  return launch_a(xr, xi, yr, yi, pre, r1, r2, post, sign, tw, nstages,
                  radices, stream);
}

// Stage a on bf16 planes (f32 compute, bf16 output).
int a0fs_a_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                __nv_bfloat16* yr, __nv_bfloat16* yi, long long pre, int r1,
                int r2, long long post, int sign, const float2* tw,
                int nstages, const int* radices, void* stream) {
  return launch_a(xr, xi, yr, yi, pre, r1, r2, post, sign, tw, nstages,
                  radices, stream);
}

// Stage b: (pre, r1 * r2, post) planes after stage a -> the natural-order
// FFT along the middle axis, scaled; radices/tw describe the r2-point one.
int a0fs_b(const float* xr, const float* xi, float* yr, float* yi,
           long long pre, int r1, int r2, long long post, int sign,
           float scale, const float2* tw, int nstages, const int* radices,
           void* stream) {
  return launch_b(xr, xi, yr, yi, pre, r1, r2, post, sign, scale, tw, nstages,
                  radices, stream);
}

// Stage b on bf16 planes (f32 compute, bf16 output).
int a0fs_b_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                __nv_bfloat16* yr, __nv_bfloat16* yi, long long pre, int r1,
                int r2, long long post, int sign, float scale,
                const float2* tw, int nstages, const int* radices,
                void* stream) {
  return launch_b(xr, xi, yr, yi, pre, r1, r2, post, sign, scale, tw, nstages,
                  radices, stream);
}

}  // extern "C"
