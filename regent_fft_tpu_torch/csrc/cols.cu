// The mid-axis FFT kernel for Hopper (sm_90a) on split re/im planes, f32
// (complex64) or bf16 (complex32):
//
//   fft_cols_kernel<T,G,R...> replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_cols
//                             (C entries fft_cols, fft_cols_bf16)
//                         and regent_fft_tpu/ops/pallas_stockham.py:_runner_axis0
//                             (C entry fft_axis0: f32, P = 1)
//
// It computes the n-point DFT along the middle axis of (P, n, V) planes,
// element (p, j, v) at (p*n + j)*V + v, with the norm scale fused into the
// write; f32 arithmetic on either plane type, the bf16 output rounded to
// nearest even once, after the scale.
// Bound on H100: bytes.  Each complex element is read once and written once
// (16 B in f32, 8 B in bf16); ~5*log2(n) flops against 16 B is far below
// the FP32 ridge (67 TFLOP/s / 3.35 TB/s = 20 flop/B).  A pass that loads
// its tile into shared memory, runs radix-4 stages there (five full
// passes at n = 512) and then stores keeps memory idle while it computes,
// and a 512-thread tile of n points is 8192 / n columns wide (16 B runs at
// n = 2048), so it is not held by bytes: its bf16 instance takes as long
// as the f32 one.  The design below is fft_last_kernel's (stockham.cu)
// turned on its side:
//   1. Columns in registers, high radix.  A column of n points is held by
//      TPC = n / E threads of E values each: E = 16 up to n = 128 (the
//      first radix where that is 8 or less), E = 32 from n = 160 on, two
//      radix-16 butterflies a thread in the first stages, so that a block
//      of 32 columns of 256 points is 256 threads.  The stage list is
//      cols_stages (ops/stockham_kernels.py): radix 16 while it fits, then
//      the rest of the power of two (2, 4 or 8), then the odd factor (3, 5
//      or 7), so every Ns is a power of two and a power of two up to 2048
//      takes at most two exchanges of shared memory (the mixed lengths
//      three at 1536).  The list is a template pack, one instance per
//      admitted length and plane type (COLS_CASE below); every radix, Ns,
//      butterfly count and twiddle offset is a compile-time constant and
//      the butterflies are straight-line code (Dft<16>, Dft<8>, radix.cuh).
//   2. Device memory straight into registers, the lanes across columns.
//      Thread t of a block takes column c = t % C of the block's C columns
//      and lane j = t / C of that column, so the 32 threads of a warp take
//      min(C, 32) neighbouring columns: every load of stage 0 (element
//      j + r*M of the column, r < R0) and every store of the last stage
//      (j + r*Ns) is a run of C elements along the contiguous axis, C*4 B
//      in f32, C*2 B in bf16.  All of a thread's loads are issued before
//      the first is used.  f32 tiles are 32 columns or more up to n = 512
//      (128 B runs), 16 up to 1024 (64 B); bf16 tiles 32 up to n = 256
//      (64 B), 16 up to 1024 (32 B).  A longer column fits fewer: 16 f32
//      columns of 2048 points are 256 KiB, more than the 227 KiB of shared
//      memory a block has and all of an SM's registers, so n = 1536 and
//      2048 take 8 columns (32 B in f32, 16 B in bf16; bf16 tiles are f32
//      on chip).  The widths are the fastest that scripts/torch_cols_widths.py
//      measured on the card: at n = 512 the f32 tile of 32 columns (one
//      512-thread block an SM) beats two resident 16-column blocks, whose
//      64 B runs cost more than their overlap gains, and in bf16 the two
//      16-column blocks beat one of 32.
//   3. Two tiles in flight an SM where they fit: __launch_bounds__(THREADS,
//      MINB) with MINB = 512 / THREADS blocks (at least one), so that ptxas
//      holds a thread to 65536 / 512 = 128 registers (170 at 192 threads)
//      and spills nothing.  Blocks of 256 threads or fewer (every length up
//      to 256, and 384 and 512 in bf16) are resident two or more at a time,
//      and one block's butterflies overlap another's loads.  The f32 tiles
//      of 384 and 512 points (384 and 512 threads) and every tile from
//      n = 640 on (320-512 threads at 32 values each, 128-224 KiB of
//      shared memory) sit one block an SM: the next block's loads start as
//      this one's stores drain.  chip_smoke.py prints each instance's
//      residency.
//   4. Exchanges: stage s writes its outputs to shared buffer s % BUFS,
//      one block barrier, stage s+1 reads them.  Two buffers (one barrier
//      an exchange) where they fit beside MINB blocks, else one, with a
//      second barrier between an exchange's reads and its writes.  Element
//      x of column c lies at x*C + c when C >= 32 (a warp's accesses are
//      one x, 32 neighbouring columns: no bank conflict); with C < 32 a
//      32-word row holds G = 32/C values of x, their column groups
//      XOR-swizzled by (x ^ x >> 4) % G, which keeps the stride-16 writes
//      of the first stage and the unit-stride reads on distinct banks
//      (tests/test_torch_port_cols_regs.py counts the conflicts).  A stage
//      of radix R gives each thread ceil((n/R) / TPC) butterflies; a thread
//      past the last repeats it and only its stores are dropped.
//   5. The ragged last tile reads column V-1 for its columns at or past V
//      and stores nothing past V.  Offsets are 64-bit: (p*n + j)*V + v
//      passes 2^31 at V = 2^22 for n = 512.
// Twiddles: the float64-generated table of the stage list (_stage_tables),
// as every kernel reads it; no sincospif.
//
// Conventions: launched on the caller's stream, never synchronises,
// allocates nothing; each C entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a length with no instance or a stage list that
// is not the instance's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham_tile.cuh"
#include "radix.cuh"

namespace {

constexpr size_t COLS_SMEM_MAX = 232448;   // bytes of shared memory a block

__host__ __device__ constexpr int clog2(int x) {
  return x <= 1 ? 0 : 1 + clog2(x / 2);
}

// Compile-time geometry of an instance: length N, E values a thread, C
// columns a block (a power of two), S stages.
template <int N_, int E, int C_, int S>
struct ColsGeo {
  static constexpr int N = N_;
  static constexpr int C = C_;
  static constexpr int LC = clog2(C);
  static constexpr int TPC = N / E;             // threads a column
  static constexpr int THREADS = TPC * C;
  static constexpr int MINB = THREADS >= 512 ? 1 : 512 / THREADS;
  static constexpr int G = C >= 32 ? 1 : 32 / C;   // x values a 32-word row
  static constexpr int LG = clog2(G);
  static constexpr int WORDS = N * C;           // one buffer's re (or im) part
  static constexpr size_t BUF = 2 * sizeof(float) * WORDS;
  static constexpr int BUFS = S < 2 ? 0
      : (S > 2 && 2 * BUF * MINB <= COLS_SMEM_MAX) ? 2 : 1;
  static constexpr size_t SMEM = BUFS * BUF;
  static_assert(TPC * E == N && (C & (C - 1)) == 0 && N % G == 0,
                "column geometry");
  static_assert(THREADS <= 1024 && SMEM <= COLS_SMEM_MAX, "block size");
  // the word of element x of column c in a buffer
  __device__ __forceinline__ static int at(int x, int c) {
    if constexpr (G == 1) {
      return x * C + c;
    } else {
      return ((x >> LG) << 5) + ((x ^ (x >> 4)) & (G - 1)) * C + c;
    }
  }
};

// What a thread works on: its column (`off`, element 0 of the column it
// reads; stores only when `valid`), the row stride ld, its lane and column
// in the block, the shared buffers.
template <typename T>
struct ColsIO {
  const T* xr;
  const T* xi;
  T* yr;
  T* yi;
  size_t off;
  size_t ld;
  bool valid;
  int lane;
  int c;
  float* sr[2];
  float* si[2];
  const float2* tw;
  float s;
  float scale;
};

// Stage ST of the list (radix R, Ns = NS, its twiddles at TWOFF), then the
// stages REST.  Butterfly j < M = N/R reads element j + r*M of the column
// (device memory at stage 0, shared buffer (ST-1) % BUFS after), twiddles
// by table entry TWOFF + (r-1)*NS + j%NS, runs an R-point DFT and writes
// (j - j%NS)*R + j%NS + r*NS (shared buffer ST % BUFS, or device memory
// with the scale at the last stage, where that is j + r*NS).
template <typename T, class G, int ST, int NS, int TWOFF, int R, int... REST>
__device__ __forceinline__ void cols_stage(const ColsIO<T>& io) {
  constexpr int M = G::N / R;
  constexpr int NB = (M + G::TPC - 1) / G::TPC;   // butterflies a thread
  constexpr bool EXACT = NB * G::TPC == M;
  float vr[NB][R], vi[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = EXACT ? io.lane + b * G::TPC
                        : min(io.lane + b * G::TPC, M - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (ST == 0) {
        const size_t o = io.off + (size_t)(j + r * M) * io.ld;
        vr[b][r] = to_f32(__ldg(io.xr + o));
        vi[b][r] = to_f32(__ldg(io.xi + o));
      } else {
        const int a = G::at(j + r * M, io.c);
        vr[b][r] = io.sr[(ST - 1) % G::BUFS][a];
        vi[b][r] = io.si[(ST - 1) % G::BUFS][a];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if constexpr (NS > 1) {
      const int j = EXACT ? io.lane + b * G::TPC
                          : min(io.lane + b * G::TPC, M - 1);
      const int k = j & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(&io.tw[TWOFF + (r - 1) * NS + k]);
        const float xr = vr[b][r], xi = vi[b][r];
        vr[b][r] = fmaf(xr, w.x, -xi * w.y);
        vi[b][r] = fmaf(xr, w.y, xi * w.x);
      }
    }
    Dft<R>::run(vr[b], vi[b], io.s);
  }
  if constexpr (sizeof...(REST) == 0) {
    static_assert(NS * R == G::N, "the stage list must multiply to N");
    if (io.valid) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = io.lane + b * G::TPC;
        if (EXACT || j < M) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const size_t o = io.off + (size_t)(j + r * NS) * io.ld;
            io.yr[o] = from_f32<T>(vr[b][r] * io.scale);
            io.yi[o] = from_f32<T>(vi[b][r] * io.scale);
          }
        }
      }
    }
  } else {
    // one buffer: every thread has read it before any overwrites it
    if constexpr (ST > 0 && G::BUFS == 1) __syncthreads();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = io.lane + b * G::TPC;
      if (EXACT || j < M) {
        const int k = j & (NS - 1);
        const int base = (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int a = G::at(base + r * NS, io.c);
          io.sr[ST % G::BUFS][a] = vr[b][r];
          io.si[ST % G::BUFS][a] = vi[b][r];
        }
      }
    }
    __syncthreads();
    cols_stage<T, G, ST + 1, NS * R, TWOFF + (R - 1) * NS, REST...>(io);
  }
}

// Block b takes columns [(b % ntiles)*C, +C) of plane b / ntiles.
template <typename T, class G, int... R>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
fft_cols_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi, long long V,
                int ntiles, const float2* __restrict__ tw, float s,
                float scale) {
  extern __shared__ float smem[];
  const int c = threadIdx.x & (G::C - 1);
  const unsigned pre = blockIdx.x / (unsigned)ntiles;
  const long long col =
      (long long)(blockIdx.x - pre * (unsigned)ntiles) * G::C + c;
  ColsIO<T> io;
  io.xr = xr;
  io.xi = xi;
  io.yr = yr;
  io.yi = yi;
  io.valid = col < V;
  io.off = (size_t)pre * G::N * (size_t)V + (size_t)(io.valid ? col : V - 1);
  io.ld = (size_t)V;
  io.lane = threadIdx.x >> G::LC;
  io.c = c;
  io.sr[0] = smem;
  io.si[0] = smem + G::WORDS;
  io.sr[1] = smem + 2 * G::WORDS;
  io.si[1] = smem + 3 * G::WORDS;
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  cols_stage<T, G, 0, 1, 0, R...>(io);
}

// One row of the instance table: length N, E values a thread, CF columns a
// block on f32 planes and CB on bf16 planes, stage list R...
template <int N, int E, int CF, int CB, int... R>
struct ColsList {};

template <typename T, int N, int E, int CF, int CB, int... R>
using ColsGeoOf = ColsGeo<N, E, sizeof(T) == 4 ? CF : CB, sizeof...(R)>;

// Calls f(ColsList<n, ...>{}) for the instance of length n, the lengths
// kernel_len_ok(n, last=False) admits up to MAX_STOCKHAM_N with their
// cols_stages lists; cudaErrorInvalidValue for any other n.
template <class F>
cudaError_t with_cols_list(int n, F&& f) {
#define COLS_CASE(n_, e_, cf_, cb_, ...) \
  case n_: return f(ColsList<n_, e_, cf_, cb_, __VA_ARGS__>{});
  switch (n) {
    //        n    E   CF   CB  stages
    COLS_CASE(2, 2, 256, 256, 2)
    COLS_CASE(4, 4, 256, 256, 4)
    COLS_CASE(8, 8, 256, 256, 8)
    COLS_CASE(16, 16, 256, 256, 16)
    COLS_CASE(24, 8, 64, 64, 8, 3)
    COLS_CASE(32, 16, 128, 128, 16, 2)
    COLS_CASE(40, 8, 32, 32, 8, 5)
    COLS_CASE(48, 16, 64, 64, 16, 3)
    COLS_CASE(56, 8, 32, 32, 8, 7)
    COLS_CASE(64, 16, 64, 64, 16, 4)
    COLS_CASE(96, 16, 32, 32, 16, 2, 3)
    COLS_CASE(128, 16, 32, 32, 16, 8)
    COLS_CASE(160, 32, 32, 32, 16, 2, 5)
    COLS_CASE(192, 32, 32, 32, 16, 4, 3)
    COLS_CASE(224, 32, 32, 32, 16, 2, 7)
    COLS_CASE(256, 32, 32, 32, 16, 16)
    COLS_CASE(384, 32, 32, 16, 16, 8, 3)
    COLS_CASE(512, 32, 32, 16, 16, 16, 2)
    COLS_CASE(640, 32, 16, 16, 16, 8, 5)
    COLS_CASE(768, 32, 16, 16, 16, 16, 3)
    COLS_CASE(896, 32, 16, 16, 16, 8, 7)
    COLS_CASE(1024, 32, 16, 16, 16, 16, 4)
    COLS_CASE(1536, 32, 8, 8, 16, 16, 2, 3)
    COLS_CASE(2048, 32, 8, 8, 16, 16, 8)
    default: return cudaErrorInvalidValue;
  }
#undef COLS_CASE
}

// Launch the instance on P (n, V) planes; the host's stage list must be the
// instance's (the C-side check of cols_stages).
template <typename T, int N, int E, int CF, int CB, int... R>
cudaError_t launch_cols_list(ColsList<N, E, CF, CB, R...>, const T* xr,
                             const T* xi, T* yr, T* yi, long long P,
                             long long V, int sign, float scale,
                             const float2* tw, int nstages,
                             const int* radices, void* stream) {
  constexpr int S = sizeof...(R);
  constexpr int rad[S] = {R...};
  if (nstages != S) return cudaErrorInvalidValue;
  for (int i = 0; i < S; ++i)
    if (radices[i] != rad[i]) return cudaErrorInvalidValue;
  if (P <= 0 || V <= 0) return cudaSuccess;
  using G = ColsGeoOf<T, N, E, CF, CB, R...>;
  const long long ntiles = (V + G::C - 1) / G::C;
  if (P * ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const void* fn = (const void*)fft_cols_kernel<T, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  if (e != cudaSuccess) return e;
  fft_cols_kernel<T, G, R...><<<(unsigned)(P * ntiles), G::THREADS, G::SMEM,
                                (cudaStream_t)stream>>>(
      xr, xi, yr, yi, V, (int)ntiles, tw, (float)sign, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const T* xr, const T* xi, T* yr, T* yi, long long P,
                        int n, long long V, int sign, float scale,
                        const float2* tw, int nstages, const int* radices,
                        void* stream) {
  return with_cols_list(n, [&](auto list) {
    return launch_cols_list(list, xr, xi, yr, yi, P, V, sign, scale, tw,
                            nstages, radices, stream);
  });
}

// The residency of the instance: out = {resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), columns a block, threads
// a block, registers a thread, shared bytes a block}.
template <typename T, int N, int E, int CF, int CB, int... R>
cudaError_t cols_residency_list(ColsList<N, E, CF, CB, R...>, int* out) {
  using G = ColsGeoOf<T, N, E, CF, CB, R...>;
  const void* fn = (const void*)fft_cols_kernel<T, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, G::THREADS,
                                                      G::SMEM);
  if (e != cudaSuccess) return e;
  out[0] = blocks;
  out[1] = G::C;
  out[2] = G::THREADS;
  out[3] = attr.numRegs;
  out[4] = (int)G::SMEM;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// FFT along the middle axis of (P, n, V) f32 planes; radices from
// cols_stages.
int fft_cols(const float* xr, const float* xi, float* yr, float* yi,
             long long P, int n, int V, int sign, float scale,
             const float2* tw, int nstages, const int* radices,
             void* stream) {
  return launch_cols(xr, xi, yr, yi, P, n, (long long)V, sign, scale, tw,
                     nstages, radices, stream);
}

// FFT along the middle axis of (P, n, V) bf16 planes (f32 compute).
int fft_cols_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                  __nv_bfloat16* yr, __nv_bfloat16* yi, long long P, int n,
                  int V, int sign, float scale, const float2* tw,
                  int nstages, const int* radices, void* stream) {
  return launch_cols(xr, xi, yr, yi, P, n, (long long)V, sign, scale, tw,
                     nstages, radices, stream);
}

// FFT along axis 0 of (n, V) f32 planes, V < 2^31.
int fft_axis0(const float* xr, const float* xi, float* yr, float* yi, int n,
              long long V, int sign, float scale, const float2* tw,
              int nstages, const int* radices, void* stream) {
  if (V > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cols(xr, xi, yr, yi, 1LL, n, V, sign, scale, tw, nstages,
                     radices, stream);
}

// The residency of the fft_cols instance for length n (bf16 != 0: its bf16
// instance): out[5] = {resident blocks an SM, columns a block, threads a
// block, registers a thread, shared bytes a block}.  Returns the CUDA error
// code (cudaErrorInvalidValue for a length with no instance).
int fft_cols_residency(int n, int bf16, int* out) {
  return with_cols_list(n, [&](auto list) {
    return bf16 ? cols_residency_list<__nv_bfloat16>(list, out)
                : cols_residency_list<float>(list, out);
  });
}

}  // extern "C"
