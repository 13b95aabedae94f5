// The register-resident column body of the mid-axis kernels for Hopper
// (sm_90a): fft_cols_kernel (cols.cu: fft_cols, fft_cols_bf16, fft_axis0),
// fft_axis_ring_kernel (ring.cu: the slab ring's axis mode) and
// fft_cols_fs_kernel (fourstep.cu: fft_cols_tw and the leading-axis
// four-step stages).  A column of N points is held by TPC = N / E threads
// of E values each, a block takes C neighbouring columns (thread t: column
// t % C, lane t / C), and the stages of the list run as straight-line code
// with one shared-memory exchange between stages (cols.cu's note gives the
// design).  The IO type fixes where stage 0 reads (device memory, or with
// IO::RING a slab that bulk copies landed in shared memory) and where the
// last stage writes (the input's layout times the scale, or with IO::STORE
// where io.store places it: FsIO, the four-step kernels' own offset, row
// stride and twiddle; ColsIlIO, interleaved complex64 output).  Here: the
// geometry (ColsGeo), the IO types, the stage recursion (cols_stage), the
// instance table (COLS_CASE, with_cols_list) and the host-side list check
// and residency query every column kernel's launcher shares.  Included after stockham_tile.cuh and
// radix.cuh; internal linkage, as they.

#pragma once

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
// columns a block (a power of two), S stages, arithmetic (and shared word)
// type V.  A row of the exchange layout is 128 bytes, the 32 banks once:
// ROW = 32 f32 words, or 16 f64 words (an f64 access is served a half warp
// at a time, 16 threads on the 32 banks).
template <int N_, int E, int C_, int S, typename V = float>
struct ColsGeo {
  static constexpr int N = N_;
  static constexpr int C = C_;
  static constexpr int LC = clog2(C);
  static constexpr int TPC = N / E;             // threads a column
  static constexpr int THREADS = TPC * C;
  static constexpr int MINB = THREADS >= 512 ? 1 : 512 / THREADS;
  static constexpr int ROW = 128 / (int)sizeof(V);
  static constexpr int LROW = clog2(ROW);
  static constexpr int G = C >= ROW ? 1 : ROW / C;   // x values a row
  static constexpr int LG = clog2(G);
  static constexpr int WORDS = N * C;           // one buffer's re (or im) part
  static constexpr size_t BUF = 2 * sizeof(V) * WORDS;
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
      return ((x >> LG) << LROW) + ((x ^ (x >> 4)) & (G - 1)) * C + c;
    }
  }
};

// What a thread works on: its column (`off`, element 0 of the column it
// reads; stores only when `valid`), the row stride ld, its lane and column
// in the block, the shared buffers, the twiddles, sign and scale in the
// arithmetic type.
template <typename T>
struct ColsIO {
  using Elem = T;
  using V = calc_t<T>;
  static constexpr bool RING = false;   // stage 0 reads device memory
  static constexpr bool STORE = false;  // element k goes to off + k*ld
  const T* xr;
  const T* xi;
  T* yr;
  T* yi;
  size_t off;
  size_t ld;
  bool valid;
  int lane;
  int c;
  V* sr[2];
  V* si[2];
  const pair_t<V>* tw;
  V s;
  V scale;
};

// The store policy of the four-step kernels (fourstep.cu): the last stage
// writes output element k of the thread's column to ooff + k*old, either
// times the four-step twiddle W_N^{k*tb}, N = 2 / step a power of two (TW;
// no scale), or times the scale.  The twiddle is formed from the exact
// integer phase k*tb < N <= 2^24: (float)(k*tb) * step is exact, so the
// only rounding is sincospif's own; no table, no recurrence.  A bf16 output
// is rounded once, after the twiddle or the scale.
template <typename T, bool TW>
struct FsIO : ColsIO<T> {
  static constexpr bool STORE = true;
  size_t ooff;   // output element 0 of the column
  size_t old;    // output row stride
  int tb;        // TW: the column's phase step
  float step;    // TW: 2 / N
  __device__ __forceinline__ void store(int k, float re, float im) const {
    if constexpr (TW) {
      float sn, cs;
      sincospif((float)(k * tb) * step, &sn, &cs);
      sn *= this->s;
      const float t = re;
      re = fmaf(t, cs, -im * sn);
      im = fmaf(t, sn, im * cs);
    } else {
      re *= this->scale;
      im *= this->scale;
    }
    const size_t o = ooff + (size_t)k * old;
    this->yr[o] = from_calc<T>(re);
    this->yi[o] = from_calc<T>(im);
  }
};

// The store policy of interleaved complex64 output (cols.cu's
// fft_cols_interleaved_out): the last stage writes output element k of the
// thread's column as one 8-byte (re, im) pair at pair off + k*ld of the
// tensor whose first word is yr (yi unused), times the scale as the planar
// store computes it; a warp's 32 neighbouring columns are 256 contiguous
// bytes.  Planar f32 input.
struct ColsIlIO : ColsIO<float> {
  static constexpr bool STORE = true;
  __device__ __forceinline__ void store(int k, float re, float im) const {
    reinterpret_cast<float2*>(yr)[off + (size_t)k * ld] =
        make_float2(re * scale, im * scale);
  }
};

// Stage ST of the list (radix R, Ns = NS, its twiddles at TWOFF), then the
// stages REST.  Butterfly j < M = N/R reads element j + r*M of the column
// (at stage 0 device memory, or with IO::RING the slab the ring landed in
// shared memory, element x of column c at x*C + c; shared buffer
// (ST-1) % BUFS after), twiddles by table entry TWOFF + (r-1)*NS + j%NS,
// runs an R-point DFT and writes (j - j%NS)*R + j%NS + r*NS (shared buffer
// ST % BUFS, or device memory at the last stage, where that is j + r*NS:
// at off + (j + r*NS)*ld with the scale, or with IO::STORE as io.store
// places it).  With IO::RING, io.release() follows stage 0's reads (the
// slab is free then), io.refill() follows them in a one-stage list and
// opens stage 1 otherwise (where no butterfly values are live), and stage
// 0 waits at a block barrier before it writes the exchange buffer, which
// the last stage of the block's previous tile may still be reading.
template <class IO, class G, int ST, int NS, int TWOFF, int R, int... REST>
__device__ __forceinline__ void cols_stage(const IO& io) {
  using T = typename IO::Elem;
  using V = calc_t<T>;
  constexpr int M = G::N / R;
  constexpr int NB = (M + G::TPC - 1) / G::TPC;   // butterflies a thread
  constexpr bool EXACT = NB * G::TPC == M;
  if constexpr (ST == 1 && IO::RING) io.refill();
  V vr[NB][R], vi[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = EXACT ? io.lane + b * G::TPC
                        : min(io.lane + b * G::TPC, M - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (ST == 0 && IO::RING) {
        const int a = (j + r * M) * G::C + io.c;
        vr[b][r] = to_calc(io.lr[a]);
        vi[b][r] = to_calc(io.li[a]);
      } else if constexpr (ST == 0) {
        const size_t o = io.off + (size_t)(j + r * M) * io.ld;
        vr[b][r] = to_calc(__ldg(io.xr + o));
        vi[b][r] = to_calc(__ldg(io.xi + o));
      } else {
        const int a = G::at(j + r * M, io.c);
        vr[b][r] = io.sr[(ST - 1) % G::BUFS][a];
        vi[b][r] = io.si[(ST - 1) % G::BUFS][a];
      }
    }
  }
  if constexpr (ST == 0 && IO::RING) {
    io.release();
    if constexpr (sizeof...(REST) == 0) io.refill();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if constexpr (NS > 1) {
      const int j = EXACT ? io.lane + b * G::TPC
                          : min(io.lane + b * G::TPC, M - 1);
      const int k = j & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const pair_t<V> w = __ldg(&io.tw[TWOFF + (r - 1) * NS + k]);
        const V xr = vr[b][r], xi = vi[b][r];
        vr[b][r] = fmac(xr, w.x, -xi * w.y);
        vi[b][r] = fmac(xr, w.y, xi * w.x);
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
            if constexpr (IO::STORE) {
              io.store(j + r * NS, vr[b][r], vi[b][r]);
            } else {
              const size_t o = io.off + (size_t)(j + r * NS) * io.ld;
              io.yr[o] = from_calc<T>(vr[b][r] * io.scale);
              io.yi[o] = from_calc<T>(vi[b][r] * io.scale);
            }
          }
        }
      }
    }
  } else {
    // one buffer: every thread has read it before any overwrites it
    if constexpr ((ST > 0 || IO::RING) && G::BUFS == 1) __syncthreads();
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
    cols_stage<IO, G, ST + 1, NS * R, TWOFF + (R - 1) * NS, REST...>(io);
  }
}

// One row of the instance table: length N, E values a thread, CF columns a
// block on f32 planes and CB on bf16 planes (on f64 planes, whose table
// has one width, CF = CB), stage list R...
template <int N, int E, int CF, int CB, int... R>
struct ColsList {};

template <typename T, int N, int E, int CF, int CB, int... R>
using ColsGeoOf = ColsGeo<N, E, sizeof(T) == 4 ? CF : CB, sizeof...(R),
                          calc_t<T>>;

template <class L>
struct ColsLen;
template <int N, int E, int CF, int CB, int... R>
struct ColsLen<ColsList<N, E, CF, CB, R...>> {
  static constexpr int value = N;
};

// Is the host's stage list the instance's?  (The C-side check of
// cols_stages.)
template <int N, int E, int CF, int CB, int... R>
bool cols_list_ok(ColsList<N, E, CF, CB, R...>, int nstages,
                  const int* radices) {
  constexpr int S = sizeof...(R);
  constexpr int rad[S] = {R...};
  if (nstages != S) return false;
  for (int i = 0; i < S; ++i)
    if (radices[i] != rad[i]) return false;
  return true;
}

// The residency of a column kernel `fn` launched with `threads` threads,
// `cols` columns a block and `smem` shared bytes: out = {resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), columns a block,
// threads a block, registers a thread, shared bytes a block}.
cudaError_t cols_residency_of(const void* fn, int threads, int cols,
                              size_t smem, int* out) {
  cudaError_t e = set_smem(fn, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  out[0] = blocks;
  out[1] = cols;
  out[2] = threads;
  out[3] = attr.numRegs;
  out[4] = (int)smem;
  return cudaSuccess;
}

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

// The same for the f64 instances (cols.cu's f64 note): every power of two
// from 2 to 1024, E values and C columns a block, the cols_stages lists.
template <class F>
cudaError_t with_cols64_list(int n, F&& f) {
#define COLS64_CASE(n_, e_, c_, ...) \
  case n_: return f(ColsList<n_, e_, c_, c_, __VA_ARGS__>{});
  switch (n) {
    //          n    E    C  stages
    COLS64_CASE(2, 2, 256, 2)
    COLS64_CASE(4, 4, 256, 4)
    COLS64_CASE(8, 8, 256, 8)
    COLS64_CASE(16, 16, 256, 16)
    COLS64_CASE(32, 16, 128, 16, 2)
    COLS64_CASE(64, 16, 64, 16, 4)
    COLS64_CASE(128, 16, 32, 16, 8)
    COLS64_CASE(256, 16, 16, 16, 16)
    COLS64_CASE(512, 16, 16, 16, 16, 2)
    COLS64_CASE(1024, 16, 8, 16, 16, 4)
    default: return cudaErrorInvalidValue;
  }
#undef COLS64_CASE
}

// The instance table of planes of type T.
template <typename T, class F>
cudaError_t with_cols_list_of(int n, F&& f) {
  if constexpr (sizeof(T) == 8)
    return with_cols64_list(n, static_cast<F&&>(f));
  else
    return with_cols_list(n, static_cast<F&&>(f));
}

}  // namespace
