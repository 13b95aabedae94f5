// The four-step column passes for Hopper (sm_90a) on split re/im planes,
// f32 (complex64) or bf16 (complex32): instances of fft_cols' register
// column body (cols.cuh) with a store policy of their own (FsIO):
//
//   fft_cols_fs_kernel<float,G,true,R...>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_cols_tw
//                                          (C entry fft_cols_tw)
//   fft_cols_fs_kernel<T,G,true,R...>      replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_a0fs, stage "a"
//                                          (C entries a0fs_a, a0fs_a_bf16)
//   fft_cols_fs_kernel<T,G,false,R...>     replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_a0fs, stage "b"
//                                          (C entries a0fs_b, a0fs_b_bf16)
//
// The kernel computes the n-point DFT along the middle axis of (P, n, V)
// planes, element (q, j, v) at (q*n + j)*V + v, and writes output element
// k of column v of plane q to ((q/g)*g*n + q%g + k*g)*V + v, times the
// four-step twiddle W_N^{k*(v/tdiv)} (TW) or times the scale:
//
//   fft_cols_tw: (b, n1, n2) planes, g = 1, tdiv = 1, N = n1*n2: the first
//     pass of the large-last-axis four-step, W_N^{k1*j2} on the write;
//   stage a: the (pre, r1, r2*post) view of a (pre, n = r1*r2, post)
//     array, input index j = a*r2 + b: the r1-point DFT over a, times
//     W_n^{k1*b} (b = v / post: tdiv = post, N = n), back to row k1*r2 + b;
//   stage b: the (pre*r1, r2, post) view, group q = p*r1 + k1: the r2-point
//     DFT over b, scaled, to row p*n + k2*r1 + k1 (g = r1), so the output
//     index k = k1 + r1*k2 comes out in natural order.
//
// f32 arithmetic on either plane type; a bf16 output (stage a's
// intermediate too, as in the JAX package) is rounded to nearest even once,
// after the twiddle or the scale.
// Bound on H100: bytes.  Each pass reads and writes every complex element
// once (16 B in f32, 8 B in bf16); ~5*log2(n) flops and, with TW, one
// sincospif an element are far below the FP32 ridge of 20 flop/B.  The
// TPU kernels contract each slab with dense stage matrices on the MXU
// (stage a's with the twiddle folded in; 'hd' one-pass bf16 dots for bf16
// planes) and synthesize fft_cols_tw's twiddle from f32 iotas; a dense
// r-point DFT in FFMA costs 8r flops an element, past the ridge at r = 64.
// Design: fft_cols_kernel's (cols.cu note), of which this differs only in
// the write.  Columns in registers (16 or 32 values a thread, the radix-16
// stages of cols_stages as straight-line code, one or two exchanges of
// shared memory between them), the lanes of a warp across neighbouring
// columns, so stage 0 loads and the last stage stores run along the
// contiguous axis straight from and to device memory (C*4 B runs in f32),
// __launch_bounds__(THREADS, 512/THREADS) so that two tiles an SM overlap
// where they fit.  The store policy (FsIO, cols.cuh) places element k at
// ooff + k*old and forms the twiddle there, one element at a time, from
// the exact integer phase k*tb < N <= 2^24 (no table, no recurrence, no
// f32 product k/N as on the TPU), so it costs no device-memory traffic.
// The ragged last tile reads column V-1 for its columns at or past V and
// stores nothing there.  Offsets are 64-bit: V = r2*post is 2^23 at 512^3
// and a plane pair of a larger batch passes 2^31 elements.
// Instances: one per length, plane type and mode from the COLS_CASE table
// (fs_max below): f32 with the twiddle at every power of two 8..2048 (the
// n1 of fft_cols_tw, and r1 of stage a), and 8..64 (the a0fs factors) for
// the other three; each C entry refuses any other length or a stage list
// that is not the instance's.
// Twiddles of the stages: the float64-generated table of the stage list
// (_stage_tables), as every kernel reads it.
//
// Conventions: launched on the caller's stream, never synchronises,
// allocates nothing; each C entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.

#include "cols.cuh"

namespace {

// Block b takes columns [(b % ntiles)*C, +C) of plane q = b / ntiles.
template <typename T, class G, bool TW, int... R>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
fft_cols_fs_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                   T* __restrict__ yr, T* __restrict__ yi, long long V,
                   int ntiles, int g, long long tdiv, float step,
                   const float2* __restrict__ tw, float s, float scale) {
  extern __shared__ float smem[];
  const int c = threadIdx.x & (G::C - 1);
  const unsigned q = blockIdx.x / (unsigned)ntiles;
  const long long col =
      (long long)(blockIdx.x - q * (unsigned)ntiles) * G::C + c;
  FsIO<T, TW> io;
  io.xr = xr;
  io.xi = xi;
  io.yr = yr;
  io.yi = yi;
  io.valid = col < V;
  io.off = (size_t)q * G::N * (size_t)V + (size_t)(io.valid ? col : V - 1);
  io.ld = (size_t)V;
  const unsigned grp = q / (unsigned)g;
  io.ooff = ((size_t)grp * g * G::N + (q - grp * (unsigned)g)) * (size_t)V
            + (size_t)col;
  io.old = (size_t)g * (size_t)V;
  // the column's own phase step, also past V (where nothing is stored)
  io.tb = TW ? (int)((unsigned long long)col / (unsigned long long)tdiv) : 0;
  io.step = step;
  io.lane = threadIdx.x >> G::LC;
  io.c = c;
  io.sr[0] = smem;
  io.si[0] = smem + G::WORDS;
  io.sr[1] = smem + 2 * G::WORDS;
  io.si[1] = smem + 3 * G::WORDS;
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  cols_stage<FsIO<T, TW>, G, 0, 1, 0, R...>(io);
}

// The largest length with an instance of the plane type and mode; the
// smallest is 8 for all.
template <typename T, bool TW>
constexpr int fs_max() {
  return sizeof(T) == 4 && TW ? 2048 : 64;
}

// Calls f(list) with the COLS_CASE list of length n where (T, TW) has an
// instance of it (a power of two 8..fs_max); cudaErrorInvalidValue else.
template <typename T, bool TW, class F>
cudaError_t with_fs_list(int n, F&& f) {
  return with_cols_list(n, [&](auto list) -> cudaError_t {
    constexpr int N = ColsLen<decltype(list)>::value;
    if constexpr (N >= 8 && N <= fs_max<T, TW>() && (N & (N - 1)) == 0)
      return f(list);
    else
      return cudaErrorInvalidValue;
  });
}

// Launch the instance on P (n, V) planes (the kernel's note gives g, tdiv
// and step = 2/N); the host's stage list must be the instance's.
template <typename T, bool TW, int N, int E, int CF, int CB, int... R>
cudaError_t launch_fs_list(ColsList<N, E, CF, CB, R...> list, const T* xr,
                           const T* xi, T* yr, T* yi, long long P,
                           long long V, int g, long long tdiv, int lN,
                           int sign, float scale, const float2* tw,
                           int nstages, const int* radices, void* stream) {
  if (!cols_list_ok(list, nstages, radices)) return cudaErrorInvalidValue;
  if (P <= 0 || V <= 0) return cudaSuccess;
  using G = ColsGeoOf<T, N, E, CF, CB, R...>;
  const long long ntiles = (V + G::C - 1) / G::C;
  if (P * ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const void* fn = (const void*)fft_cols_fs_kernel<T, G, TW, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  if (e != cudaSuccess) return e;
  fft_cols_fs_kernel<T, G, TW, R...><<<(unsigned)(P * ntiles), G::THREADS,
                                       G::SMEM, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, V, (int)ntiles, g, tdiv, ldexpf(1.0f, 1 - lN), tw,
      (float)sign, scale);
  return cudaGetLastError();
}

template <typename T, bool TW>
cudaError_t launch_fs(const T* xr, const T* xi, T* yr, T* yi, long long P,
                      int n, long long V, int g, long long tdiv, int lN,
                      int sign, float scale, const float2* tw, int nstages,
                      const int* radices, void* stream) {
  return with_fs_list<T, TW>(n, [&](auto list) {
    return launch_fs_list<T, TW>(list, xr, xi, yr, yi, P, V, g, tdiv, lN,
                                 sign, scale, tw, nstages, radices, stream);
  });
}

// The residency of the instance (cols_residency_of).
template <typename T, bool TW, int N, int E, int CF, int CB, int... R>
cudaError_t fs_residency_list(ColsList<N, E, CF, CB, R...>, int* out) {
  using G = ColsGeoOf<T, N, E, CF, CB, R...>;
  return cols_residency_of((const void*)fft_cols_fs_kernel<T, G, TW, R...>,
                           G::THREADS, G::C, G::SMEM, out);
}

template <typename T, bool TW>
cudaError_t fs_residency(int n, int* out) {
  return with_fs_list<T, TW>(n, [&](auto list) {
    return fs_residency_list<T, TW>(list, out);
  });
}

// Stage a over (pre, r1*r2, post) planes: the r1 instance on the
// (pre, r1, r2*post) view, W_n^{k1*(v/post)} on the write.
template <typename T>
cudaError_t launch_a(const T* xr, const T* xi, T* yr, T* yi, long long pre,
                     int r1, int r2, long long post, int sign,
                     const float2* tw, int nstages, const int* radices,
                     void* stream) {
  const long long n = (long long)r1 * r2;
  if (r2 < 1 || post < 1 || (n & (n - 1)) || n > (1 << 24))
    return cudaErrorInvalidValue;
  return launch_fs<T, true>(xr, xi, yr, yi, pre, r1, r2 * post, 1, post,
                            clog2((int)n), sign, 1.0f, tw, nstages, radices,
                            stream);
}

// Stage b: the r2 instance on the (pre*r1, r2, post) view, each group's
// rows r1*post apart in the output, scaled.
template <typename T>
cudaError_t launch_b(const T* xr, const T* xi, T* yr, T* yi, long long pre,
                     int r1, int r2, long long post, int sign, float scale,
                     const float2* tw, int nstages, const int* radices,
                     void* stream) {
  if (r1 < 1 || post < 1) return cudaErrorInvalidValue;
  return launch_fs<T, false>(xr, xi, yr, yi, pre * r1, r2, post, r1, 1LL, 1,
                             sign, scale, tw, nstages, radices, stream);
}

}  // namespace

extern "C" {

// Four-step first pass over (P, n1, n2) f32 planes: n1-point FFT along the
// middle axis times W_{n1*n2}^{k1*j2}; n1 * n2 a power of two <= 2^24;
// radices from cols_stages.
int fft_cols_tw(const float* xr, const float* xi, float* yr, float* yi,
                long long P, int n1, int n2, int sign, const float2* tw,
                int nstages, const int* radices, void* stream) {
  const long long big_n = (long long)n1 * n2;
  if (n2 < 1 || big_n > (1 << 24) || (big_n & (big_n - 1)))
    return cudaErrorInvalidValue;
  return launch_fs<float, true>(xr, xi, yr, yi, P, n1, n2, 1, 1LL,
                                clog2((int)big_n), sign, 1.0f, tw, nstages,
                                radices, stream);
}

// Stage a of the leading-axis four-step over (pre, r1 * r2, post) planes;
// radices/tw describe the r1-point transform (cols_stages).
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

// The residency of the four-step instance for length n (bf16 != 0: on bf16
// planes; tw != 0: with the twiddle, as fft_cols_tw and stage a, else stage
// b's): out[5] = {resident blocks an SM, columns a block, threads a block,
// registers a thread, shared bytes a block}.  Returns the CUDA error code
// (cudaErrorInvalidValue for a length with no instance).
int fft_cols_fs_residency(int n, int bf16, int tw, int* out) {
  if (bf16)
    return tw ? fs_residency<__nv_bfloat16, true>(n, out)
              : fs_residency<__nv_bfloat16, false>(n, out);
  return tw ? fs_residency<float, true>(n, out)
            : fs_residency<float, false>(n, out);
}

}  // extern "C"
