// Real-transform (R2C / C2R) kernels for Hopper (sm_90a) on the
// register-resident row body of last.cuh:
//
//   fft_last_r2c_kernel<N,R...>   replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_last_r2c
//   ifft_last_c2r_kernel<N,R...>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_last_c2r
//
// Both work on the last axis of (B, n) rows, n an even power of two <= 1024
// (r2c_last_supported), two real rows at a time: rows 2p and 2p+1 are the
// real and imaginary parts of one complex row z, so one n-point complex
// transform serves two real transforms.  An odd B pairs the last row with
// zeros and writes nothing for the missing row.
//
// Half-spectrum layouts (w bins per row):
//   narrow  w = n/2 + 1, bins 0..n/2;
//   packed  w = n/2, bins 0..n/2-1, with the real bin n/2 stored in bin 0's
//           imaginary slot (bin 0 itself is real).
// The JAX package's third, lane-padded (B, n) layout only keeps later TPU
// passes lane-aligned; the port's plan steps take the narrow planes.
//
// Bound on H100: bytes.  4 B read per real element and 2 * 4 B written per
// bin, or the reverse (narrow 4096 x 1024: 16.8 MB in + 16.8 MB out, 0.0100
// ms at 3.35 TB/s; packed 262144 x 256: 268 MB + 268 MB, 0.160 ms), against
// ~2.5*log2(n) flops per real element, far below the FP32 ridge of 20 flop/B.
//
// Design: one row of the body is one pair p (LastGeo: n/16 threads a pair
// from n = 16 on, 128 threads a block; one thread a pair below), with the
// stages of last_stages(n), one instance per admitted length (REAL_CASE).
//   fft_last_r2c_kernel: stage 0 loads row 2p into the real and row 2p+1
//     into the imaginary part, straight into registers; the stages run with
//     sign -1; the last stage stores Z = FFT(z) in natural order into the
//     shared buffer the stage list leaves free (one added exchange), and
//     after one barrier lane l untangles bins l + i*n/16 from Z[k] and
//     Z[(n-k) mod n],
//         X1[k] = (Z[k] + conj Z[-k]) / 2,   X2[k] = (Z[k] - conj Z[-k]) / (2i),
//     writing X1 to row 2p and X2 to row 2p+1, coalesced along k (scalar
//     stores: a narrow row is n/2+1 bins wide, so no row is 16 B aligned).
//     For n <= 16 one thread holds the row and the untangle runs in its
//     registers.
//   ifft_last_c2r_kernel: stage 0 builds Z[j] = X1[j] + i X2[j] (j <= n/2)
//     and conj X1[n-j] + i conj X2[n-j] (j > n/2, a descending contiguous
//     run; its second read of a bin comes from L1/L2) straight from the half
//     spectra into registers; the stages run with sign +1 and the last
//     stage writes Re z to row 2p and Im z to row 2p+1 with the scale.  No
//     exchange beyond the body's own.
// What is dropped from the TPU kernels: their reversed-row tail tables
// (_r2c_tables, _fwd_and_rev_spectra) and the c2r permutation-matrix product
// (prev_np) exist because Mosaic cannot flip a sublane axis.  Here the
// frequency reversal k -> (n - k) mod n is an index into shared memory (r2c)
// or into the input row (c2r).

#include "last.cuh"

namespace {

// The pair of the thread's row of LastGeo, then the body in mode MODE.  In
// and out rows are `in` and `out` elements wide (n and w for R2C, the
// reverse for C2R).
template <LastMode MODE, int N, int... R>
__device__ __forceinline__ void real_rows(const float* xr, const float* xi,
                                          float* yr, float* yi, long long B,
                                          int packed, const float2* tw,
                                          float s, float scale) {
  using G = LastGeo<N, first_radix<R...>()>;
  extern __shared__ float smem[];
  const int rl = threadIdx.x / G::TPR;
  const long long pairs = (B + 1) / 2;
  const long long pair = (long long)blockIdx.x * G::RPB + rl;
  const int w = packed ? N / 2 : N / 2 + 1;
  const size_t in = MODE == LastMode::R2C ? N : w;
  const size_t out = MODE == LastMode::R2C ? w : N;
  const long long row = 2 * (pair < pairs ? pair : pairs - 1);
  RealIO<MODE> io;
  io.xr = xr;
  io.xi = xi;
  io.yr = yr;
  io.yi = yi;
  io.valid = pair < pairs;
  io.valid2 = row + 1 < B;
  io.off = (size_t)row * in;
  io.off2 = io.valid2 ? io.off + in : io.off;
  io.out = (size_t)row * out;
  io.out2 = io.out + out;
  io.packed = packed;
  io.lane = threadIdx.x - rl * G::TPR;
  last_smem_rows<G>(io, smem, rl);
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  last_stage<RealIO<MODE>, G, N, 0, 1, 0, R...>(io);
}

// R2C of (B, N) f32 rows -> (B, w) f32 planes, scale fused into the write.
template <int N, int... R>
__global__ void __launch_bounds__(LAST_BLOCK, LAST_MIN_BLOCKS)
fft_last_r2c_kernel(const float* __restrict__ x, float* __restrict__ yr,
                    float* __restrict__ yi, long long B, int packed,
                    const float2* __restrict__ tw, float scale) {
  real_rows<LastMode::R2C, N, R...>(x, x, yr, yi, B, packed, tw, -1.0f,
                                    scale);
}

// N times the inverse: (B, w) f32 half-spectrum planes -> (B, N) f32 rows,
// scale fused into the write.
template <int N, int... R>
__global__ void __launch_bounds__(LAST_BLOCK, LAST_MIN_BLOCKS)
ifft_last_c2r_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi, float* __restrict__ y,
                     long long B, int packed, const float2* __restrict__ tw,
                     float scale) {
  real_rows<LastMode::C2R, N, R...>(xr, xi, y, y, B, packed, tw, 1.0f,
                                    scale);
}

// Calls f(LastList<n, radices...>{}) for the instance of length n, the
// lengths r2c_last_supported admits with their last_stages lists;
// cudaErrorInvalidValue for any other n.
template <class F>
cudaError_t with_real_list(int n, F&& f) {
#define REAL_CASE(n_, ...) \
  case n_: return f(LastList<n_, __VA_ARGS__>{});
  switch (n) {
    REAL_CASE(2, 2)
    REAL_CASE(4, 4)
    REAL_CASE(8, 8)
    REAL_CASE(16, 16)
    REAL_CASE(32, 16, 2)
    REAL_CASE(64, 16, 4)
    REAL_CASE(128, 16, 8)
    REAL_CASE(256, 16, 16)
    REAL_CASE(512, 16, 16, 2)
    REAL_CASE(1024, 16, 16, 4)
    default: return cudaErrorInvalidValue;
  }
#undef REAL_CASE
}

// The kernel of mode MODE for the instance, its shared bytes (R2C with an
// exchange keeps a buffer for the untangle beside the list's: two at most)
// and its launch geometry.
template <LastMode MODE, int N, int... R>
const void* real_kernel() {
  if constexpr (MODE == LastMode::R2C)
    return (const void*)fft_last_r2c_kernel<N, R...>;
  else
    return (const void*)ifft_last_c2r_kernel<N, R...>;
}

template <LastMode MODE, int N, int... R>
constexpr size_t real_smem() {
  constexpr int S = sizeof...(R);
  constexpr int X = MODE == LastMode::R2C && S > 1 ? S + 1 : S;
  return last_smem<N, first_radix<R...>(), X>();
}

// Launch the instance on B rows (RPB pairs a block); the host's stage list
// must be the instance's (the C-side check of last_stages).
template <LastMode MODE, int N, int... R>
cudaError_t launch_real_list(LastList<N, R...> list, const float* xr,
                             const float* xi, float* yr, float* yi,
                             long long B, int packed, float scale,
                             const float2* tw, int nstages, const int* radices,
                             void* stream) {
  if (!last_list_ok(list, nstages, radices)) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  using G = LastGeo<N, first_radix<R...>()>;
  const long long grid = ((B + 1) / 2 + G::RPB - 1) / G::RPB;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = real_smem<MODE, N, R...>();
  cudaError_t e = set_smem(real_kernel<MODE, N, R...>(), smem);
  if (e != cudaSuccess) return e;
  if constexpr (MODE == LastMode::R2C)
    fft_last_r2c_kernel<N, R...><<<(unsigned)grid, G::THREADS, smem,
                                   (cudaStream_t)stream>>>(
        xr, yr, yi, B, packed, tw, scale);
  else
    ifft_last_c2r_kernel<N, R...><<<(unsigned)grid, G::THREADS, smem,
                                    (cudaStream_t)stream>>>(
        xr, xi, yr, B, packed, tw, scale);
  return cudaGetLastError();
}

// The residency of the instance of mode MODE (last_residency_of).
template <LastMode MODE, int N, int... R>
cudaError_t real_residency_list(LastList<N, R...>, int* out) {
  using G = LastGeo<N, first_radix<R...>()>;
  return last_residency_of(real_kernel<MODE, N, R...>(), G::THREADS, G::RPB,
                           real_smem<MODE, N, R...>(), out);
}

}  // namespace

extern "C" {

// R2C along the last axis of (B, n) f32 rows -> (B, w) f32 planes; radices
// from last_stages.
int fft_last_r2c(const float* x, float* yr, float* yi, long long B, int n,
                 int packed, float scale, const float2* tw, int nstages,
                 const int* radices, void* stream) {
  return with_real_list(n, [&](auto list) {
    return launch_real_list<LastMode::R2C>(list, x, x, yr, yi, B, packed,
                                           scale, tw, nstages, radices,
                                           stream);
  });
}

// n times the inverse: (B, w) f32 half-spectrum planes -> (B, n) f32 rows;
// radices from last_stages.
int ifft_last_c2r(const float* xr, const float* xi, float* y, long long B,
                  int n, int packed, float scale, const float2* tw,
                  int nstages, const int* radices, void* stream) {
  return with_real_list(n, [&](auto list) {
    return launch_real_list<LastMode::C2R>(list, xr, xi, y, y, B, packed,
                                           scale, tw, nstages, radices,
                                           stream);
  });
}

// The residency of the real pair kernel for length n (c2r != 0:
// ifft_last_c2r's, else fft_last_r2c's): out[5] = {resident blocks an SM,
// pairs a block, threads a block, registers a thread, shared bytes a
// block}.  Returns the CUDA error code (cudaErrorInvalidValue for a length
// with no instance).
int fft_last_real_residency(int n, int c2r, int* out) {
  return with_real_list(n, [&](auto list) {
    return c2r ? real_residency_list<LastMode::C2R>(list, out)
               : real_residency_list<LastMode::R2C>(list, out);
  });
}

}  // extern "C"
