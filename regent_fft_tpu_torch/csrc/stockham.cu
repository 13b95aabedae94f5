// Self-sorting Stockham C2C FFT kernels for Hopper (sm_90a) on split re/im
// planes: f32 (complex64) or bf16 (complex32).  The shared tile (fft_tile,
// rows_pass, cols_pass) is in stockham_tile.cuh; the kernels here differ
// only in how they address global memory:
//
//   fft_last_kernel<T>    replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_last
//   fft_cols_kernel<T>    replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_cols
//   fft_cols_tw_kernel    replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_cols_tw
//   fft_fused2_kernel<T>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_fused2
//   fft_gap_kernel<T>     replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_fused2_gap
//
// Each computes one DFT along an axis (two for fused2 and gap) with the norm
// scale (or, for fft_cols_tw, the four-step twiddle) fused into the final
// write.
//
// The bf16 instances (C entries fft_last_bf16, fft_cols_bf16,
// fft_fused2_bf16) replace the same three runners with io="bf16", whose
// bodies on the TPU are _direct_tile (a dense DFT_n MXU dot, n <= 512),
// _mxu_tile_tw (the twiddle-folded four-step, n = 1024 and 2048) and
// _stockham_tile with bf16 blocks (every other length).  The TPU used the
// MXU because its vector unit is weak; on this card a dense DFT_n costs
// 6*n flops per element in 3M form (3072 at n = 512) against ~5*log2(n) for
// the butterflies, and the f32 kernels are bytes-bound well below the FP32
// ridge, so the bf16 instances run the same f32 FFMA tile on bf16 blocks:
// each element is read as 4 B (bf16 re + im) instead of 8 and written the
// same, converted to f32 on load and rounded to nearest even on the store.
// Bound on H100 for them: bytes, 8 B per complex element per pass (half the
// f32 kernels' 16 B).  fft_fused2_bf16 and fft_gap_bf16 (the bf16 instance of
// the gap kernel, whose TPU body is _stockham_tile on either block type) keep
// the plane between their column and row passes in f32, as the TPU kernels
// do in VMEM: the column pass writes it to f32 scratch planes the wrapper
// allocates, the row pass reads them and rounds the output to bf16 once.
// The scratch is whole-tensor, laid out like the output (8 B per element,
// 1 GiB at 512^3), because the grid is one block per plane and each block
// then owns its scratch plane with no indexing of its own; it moves 24 B
// per element through device memory instead of the 16 B of a bf16
// intermediate.
//
//   fft_axis0             replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_axis0
//
// is one more launcher of fft_cols_kernel<float>: the FFT along axis 0 of
// (n, V) f32 planes, the (P, n, V) body with P = 1, scale fused.

#include "stockham_tile.cuh"

namespace {

// --------------------------------------------------------------------------
// fft_last_kernel — replaces pallas_stockham.py:_runner_last (FFT along the
// last axis of (B, n) planes, norm scale fused into the write).
// Bound on H100: bytes.  Each complex element is read once and written once
// (16 B), ~5*log2(n) flops against 16 B is far below the FP32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 flop/B).  Design: each block takes nt whole
// rows, loaded coalesced into shared memory (one read, one write of HBM per
// element); every butterfly stage stays in shared memory.  The ragged last
// block is masked, not padded.
// --------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fft_last_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi, long long B,
                StagePlan p, const float2* __restrict__ tw, float s,
                float scale) {
  extern __shared__ float smem[];
  const Geo g = rows_geo(p.n);
  float* sr = smem;
  float* si = smem + g.nt * g.pitch;
  rows_pass(xr, xi, yr, yi, (long long)blockIdx.x * g.nt, B, p.n, p, tw, s,
            scale, sr, si);
}

// --------------------------------------------------------------------------
// fft_cols_kernel — replaces pallas_stockham.py:_runner_cols (FFT along the
// middle axis of (P, n, V) planes, scale fused).
// Bound on H100: bytes, as above (16 B per complex element, one pass).
// Design: a block takes one (pre-slice p, column tile) pair; neighbouring
// threads take neighbouring v, so every global access is a contiguous run
// of nt floats, and each column is transformed along n in shared memory.
// V % nt is masked.  nt is 16 at n = 512 (64 B runs, 64 KiB of shared
// memory per block).
// --------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fft_cols_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi, int V,
                int ntiles, StagePlan p, const float2* __restrict__ tw, float s,
                float scale) {
  extern __shared__ float smem[];
  const Geo g = cols_geo(p.n);
  float* sr = smem;
  float* si = smem + p.n * g.nt;
  const long long pre = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * g.nt;
  const size_t base = (size_t)pre * p.n * V;
  cols_pass(xr + base, xi + base, yr + base, yi + base, c0, V, p, tw, s, scale,
            sr, si);
}

// --------------------------------------------------------------------------
// fft_cols_tw_kernel — replaces pallas_stockham.py:_runner_cols_tw, the first
// pass of the large-last-axis four-step: over (b, n1, n2) planes (a last axis
// of length N = n1 * n2 viewed as rows of n2), the n1-point FFT along the
// middle axis, then the twiddle W_N^{k1 * j2} on the write.
// Bound on H100: bytes (16 B per complex element, one pass; ~5*log2(n1) + 6
// flops and one sincospif per element, far below the FP32 ridge).  Design:
// fft_cols_kernel's column tiles; the twiddle is formed in the write from the
// exact integer phase index k1 * j2 < N <= 2^21 (no table, no f32 product
// k1 * j2 / N as on the TPU), so it costs no device-memory traffic.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 2)
fft_cols_tw_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi, int V,
                   int ntiles, StagePlan p, const float2* __restrict__ tw,
                   float s, int lN) {
  extern __shared__ float smem[];
  const Geo g = cols_geo(p.n);
  float* sr = smem;
  float* si = smem + p.n * g.nt;
  const long long pre = blockIdx.x / ntiles;
  const int c0 = (blockIdx.x % ntiles) * g.nt;
  const size_t base = (size_t)pre * p.n * V;
  cols_pass(xr + base, xi + base, yr + base, yi + base, c0, V, V, p, tw, s,
            1.0f, sr, si, ColsOut{V, lN, 1});
}

// --------------------------------------------------------------------------
// fft_fused2_kernel — replaces pallas_stockham.py:_runner_fused2 (FFT along
// both trailing axes of (P, n1, n2) planes, scale fused).
// Bound on H100: bytes — one read and one write of each element (16 B) if
// the plane stayed on chip.  A plane can be 262144 complex f32 = 2 MiB, more
// than the 227 KB of shared memory a block can use, so this simple version
// runs the column pass (along n1) from the input into the output buffer
// (for bf16 data: into the f32 scratch planes), synchronises the block (the
// block owns the plane, so no other block touches it), and runs the row
// pass (along n2) from there into the output with the scale fused.  That costs up to two plane passes of HBM traffic once
// the 50 MB L2 no longer holds the working planes (at 512^3, 2 MiB planes in
// flight on every SM).  A thread-block-cluster / distributed-shared-memory
// design that keeps the whole plane on chip is later work.
// --------------------------------------------------------------------------

// The body of fft_fused2_kernel and fft_gap_kernel: the (n1, n2) plane at
// `base` whose rows are `ld` elements apart, columns (n1) from x into the f32
// planes m (the output planes themselves for f32 data, the scratch planes
// for bf16), then rows (n2) from m into y with the scale.
template <typename T>
__device__ __forceinline__ void plane2(const T* xr, const T* xi, float* mr,
                                       float* mi, T* yr, T* yi, size_t base,
                                       long long ld, const StagePlan& p1,
                                       const float2* __restrict__ tw1,
                                       const StagePlan& p2,
                                       const float2* __restrict__ tw2, float s,
                                       float scale, float* smem) {
  const int n1 = p1.n, n2 = p2.n;
  // column pass: axis n1, tiles of nt columns
  {
    const Geo g = cols_geo(n1);
    float* sr = smem;
    float* si = smem + n1 * g.nt;
    for (int c0 = 0; c0 < n2; c0 += g.nt)
      cols_pass(xr + base, xi + base, mr + base, mi + base, c0, n2, ld, p1,
                tw1, s, 1.0f, sr, si, ColsOut{ld, 0, 1});
  }
  // cols_pass ended on __syncthreads(): the block's global writes above are
  // visible to all of its threads.
  {
    const Geo g = rows_geo(n2);
    float* sr = smem;
    float* si = smem + g.nt * g.pitch;
    for (int r0 = 0; r0 < n1; r0 += g.nt)
      rows_pass(mr + base, mi + base, yr + base, yi + base, r0, n1, ld, p2,
                tw2, s, scale, sr, si);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fft_fused2_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  float* mr, float* mi, T* yr, T* yi, StagePlan p1,
                  const float2* __restrict__ tw1, StagePlan p2,
                  const float2* __restrict__ tw2, float s, float scale) {
  extern __shared__ float smem[];
  plane2(xr, xi, mr, mi, yr, yi, (size_t)blockIdx.x * p1.n * p2.n, p2.n, p1,
         tw1, p2, tw2, s, scale, smem);
}

// --------------------------------------------------------------------------
// fft_gap_kernel — replaces pallas_stockham.py:_runner_fused2_gap (FFT along
// axes -3 and -1 of (B, z, Y, x) planes, scale fused): one block per (b, y)
// plane, the (z, x) block at b*z*Y*x + y*x with rows Y*x elements apart
// (1 MiB in f32 at 512^3).
// Bound on H100: bytes, as fft_fused2_kernel (16 B per complex element for
// f32, 8 B for bf16, if the plane stayed on chip).  Design:
// fft_fused2_kernel's two passes on the strided plane (plane2 with the row
// stride Y*x): the z-point column pass from the input into the output, then
// the x-point row pass in place.  Nothing is copied in or out around it.
// Each column-pass row read is a run of nt elements (64 B in f32 at z = 512)
// at a stride of Y*x; the TPU kernel pays the same big-stride gather once
// for two axes (its VMEM strip rule, REGENT_FFT_GAP_STRIPS, has no
// counterpart here).  The bf16 instance keeps the intermediate in f32
// scratch planes laid out like the output, as fft_fused2_bf16 does.
// --------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fft_gap_kernel(const T* __restrict__ xr, const T* __restrict__ xi, float* mr,
               float* mi, T* yr, T* yi, int Y, StagePlan p1,
               const float2* __restrict__ tw1, StagePlan p2,
               const float2* __restrict__ tw2, float s, float scale) {
  extern __shared__ float smem[];
  const long long ld = (long long)Y * p2.n;
  const long long b = blockIdx.x / Y, y = blockIdx.x - b * Y;
  plane2(xr, xi, mr, mi, yr, yi, (size_t)b * p1.n * ld + (size_t)y * p2.n, ld,
         p1, tw1, p2, tw2, s, scale, smem);
}

// Host launchers, one per kernel template, shared by the f32 and bf16 C
// entries below.
template <typename T>
cudaError_t launch_last(const T* xr, const T* xi, T* yr, T* yi, long long B,
                        int n, int sign, float scale, const float2* tw,
                        int nstages, const int* radices, void* stream) {
  StagePlan p;
  if (make_plan(n, nstages, radices, &p)) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const size_t smem = rows_smem_bytes(n);
  cudaError_t e = set_smem((const void*)fft_last_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const long long grid = (B + rows_geo(n).nt - 1) / rows_geo(n).nt;
  fft_last_kernel<T><<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, B, p, tw, (float)sign, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const T* xr, const T* xi, T* yr, T* yi, long long P,
                        int n, int V, int sign, float scale, const float2* tw,
                        int nstages, const int* radices, void* stream) {
  StagePlan p;
  if (make_plan(n, nstages, radices, &p)) return cudaErrorInvalidValue;
  if (P <= 0 || V <= 0) return cudaSuccess;
  const size_t smem = cols_smem_bytes(n);
  cudaError_t e = set_smem((const void*)fft_cols_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int nt = cols_geo(n).nt;
  const int ntiles = (V + nt - 1) / nt;
  const long long grid = P * ntiles;
  fft_cols_kernel<T><<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, V, ntiles, p, tw, (float)sign, scale);
  return cudaGetLastError();
}

// `mr`, `mi`: the f32 planes between the two passes (the output planes for
// f32 data).
template <typename T>
cudaError_t launch_fused2(const T* xr, const T* xi, float* mr, float* mi,
                          T* yr, T* yi, long long P,
                          int n1, int n2, int sign, float scale,
                          const float2* tw1, int nstages1, const int* radices1,
                          const float2* tw2, int nstages2, const int* radices2,
                          void* stream) {
  StagePlan p1, p2;
  if (make_plan(n1, nstages1, radices1, &p1)) return cudaErrorInvalidValue;
  if (make_plan(n2, nstages2, radices2, &p2)) return cudaErrorInvalidValue;
  if (P <= 0) return cudaSuccess;
  const size_t a = cols_smem_bytes(n1), b = rows_smem_bytes(n2);
  const size_t smem = a > b ? a : b;
  cudaError_t e = set_smem((const void*)fft_fused2_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  fft_fused2_kernel<T><<<(unsigned)P, THREADS, smem, (cudaStream_t)stream>>>(
      xr, xi, mr, mi, yr, yi, p1, tw1, p2, tw2, (float)sign, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gap(const T* xr, const T* xi, float* mr, float* mi, T* yr,
                       T* yi, long long B,
                       int z, int Y, int x, int sign, float scale,
                       const float2* tw1, int nstages1, const int* radices1,
                       const float2* tw2, int nstages2, const int* radices2,
                       void* stream) {
  StagePlan p1, p2;
  if (make_plan(z, nstages1, radices1, &p1)) return cudaErrorInvalidValue;
  if (make_plan(x, nstages2, radices2, &p2)) return cudaErrorInvalidValue;
  if (Y < 1 || B * Y > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const size_t a = cols_smem_bytes(z), b = rows_smem_bytes(x);
  const size_t smem = a > b ? a : b;
  cudaError_t e = set_smem((const void*)fft_gap_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  fft_gap_kernel<T><<<(unsigned)(B * Y), THREADS, smem,
                      (cudaStream_t)stream>>>(xr, xi, mr, mi, yr, yi, Y, p1,
                                              tw1, p2, tw2, (float)sign,
                                              scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// FFT along the last axis of (B, n) f32 planes.
int fft_last(const float* xr, const float* xi, float* yr, float* yi, long long B,
             int n, int sign, float scale, const float2* tw, int nstages,
             const int* radices, void* stream) {
  return launch_last(xr, xi, yr, yi, B, n, sign, scale, tw, nstages, radices,
                     stream);
}

// FFT along the last axis of (B, n) bf16 planes (f32 compute).
int fft_last_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                  __nv_bfloat16* yr, __nv_bfloat16* yi, long long B, int n,
                  int sign, float scale, const float2* tw, int nstages,
                  const int* radices, void* stream) {
  return launch_last(xr, xi, yr, yi, B, n, sign, scale, tw, nstages, radices,
                     stream);
}

// FFT along the middle axis of (P, n, V) f32 planes.
int fft_cols(const float* xr, const float* xi, float* yr, float* yi, long long P,
             int n, int V, int sign, float scale, const float2* tw, int nstages,
             const int* radices, void* stream) {
  return launch_cols(xr, xi, yr, yi, P, n, V, sign, scale, tw, nstages,
                     radices, stream);
}

// FFT along the middle axis of (P, n, V) bf16 planes (f32 compute).
int fft_cols_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                  __nv_bfloat16* yr, __nv_bfloat16* yi, long long P, int n,
                  int V, int sign, float scale, const float2* tw, int nstages,
                  const int* radices, void* stream) {
  return launch_cols(xr, xi, yr, yi, P, n, V, sign, scale, tw, nstages,
                     radices, stream);
}

// FFT along axis 0 of (n, V) f32 planes.
int fft_axis0(const float* xr, const float* xi, float* yr, float* yi, int n,
              long long V, int sign, float scale, const float2* tw,
              int nstages, const int* radices, void* stream) {
  if (V > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cols(xr, xi, yr, yi, 1LL, n, (int)V, sign, scale, tw, nstages,
                     radices, stream);
}

// Four-step first pass over (P, n1, n2) f32 planes: n1-point FFT along the
// middle axis times W_{n1*n2}^{k1*j2}; n1 * n2 a power of two <= 2^24.
int fft_cols_tw(const float* xr, const float* xi, float* yr, float* yi,
                long long P, int n1, int n2, int sign, const float2* tw,
                int nstages, const int* radices, void* stream) {
  StagePlan p;
  if (make_plan(n1, nstages, radices, &p)) return cudaErrorInvalidValue;
  const long long big_n = (long long)n1 * n2;
  if (n2 < 1 || big_n > (1 << 24) || (big_n & (big_n - 1)))
    return cudaErrorInvalidValue;
  if (P <= 0) return cudaSuccess;
  const size_t smem = cols_smem_bytes(n1);
  cudaError_t e = set_smem((const void*)fft_cols_tw_kernel, smem);
  if (e != cudaSuccess) return e;
  const int nt = cols_geo(n1).nt;
  const int ntiles = (n2 + nt - 1) / nt;
  fft_cols_tw_kernel<<<(unsigned)(P * ntiles), THREADS, smem,
                       (cudaStream_t)stream>>>(xr, xi, yr, yi, n2, ntiles, p,
                                               tw, (float)sign,
                                               ilog2((int)big_n));
  return cudaGetLastError();
}

// FFT along both trailing axes of (P, n1, n2) f32 planes.
int fft_fused2(const float* xr, const float* xi, float* yr, float* yi,
               long long P, int n1, int n2, int sign, float scale,
               const float2* tw1, int nstages1, const int* radices1,
               const float2* tw2, int nstages2, const int* radices2,
               void* stream) {
  return launch_fused2(xr, xi, yr, yi, yr, yi, P, n1, n2, sign, scale, tw1,
                       nstages1, radices1, tw2, nstages2, radices2, stream);
}

// FFT along both trailing axes of (P, n1, n2) bf16 planes (f32 compute); the
// intermediate between the two passes goes to the f32 (P, n1, n2) scratch
// planes mr, mi.
int fft_fused2_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                    __nv_bfloat16* yr, __nv_bfloat16* yi, float* mr, float* mi,
                    long long P, int n1, int n2, int sign, float scale,
                    const float2* tw1, int nstages1, const int* radices1,
                    const float2* tw2, int nstages2, const int* radices2,
                    void* stream) {
  return launch_fused2(xr, xi, mr, mi, yr, yi, P, n1, n2, sign, scale, tw1,
                       nstages1, radices1, tw2, nstages2, radices2, stream);
}

// FFT along axes -3 and -1 of (B, z, Y, x) f32 planes (one pass).
int fft_gap(const float* xr, const float* xi, float* yr, float* yi,
            long long B, int z, int Y, int x, int sign, float scale,
            const float2* tw1, int nstages1, const int* radices1,
            const float2* tw2, int nstages2, const int* radices2,
            void* stream) {
  return launch_gap(xr, xi, yr, yi, yr, yi, B, z, Y, x, sign, scale, tw1,
                    nstages1, radices1, tw2, nstages2, radices2, stream);
}

// The same on bf16 planes (f32 compute); the intermediate between the two
// passes goes to the f32 (B, z, Y, x) scratch planes mr, mi.
int fft_gap_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                 __nv_bfloat16* yr, __nv_bfloat16* yi, float* mr, float* mi,
                 long long B, int z, int Y, int x, int sign, float scale,
                 const float2* tw1, int nstages1, const int* radices1,
                 const float2* tw2, int nstages2, const int* radices2,
                 void* stream) {
  return launch_gap(xr, xi, mr, mi, yr, yi, B, z, Y, x, sign, scale, tw1,
                    nstages1, radices1, tw2, nstages2, radices2, stream);
}

}  // extern "C"
