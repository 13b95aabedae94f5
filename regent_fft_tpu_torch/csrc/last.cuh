// The register-resident row body of the last-axis kernels for Hopper
// (sm_90a): fft_last_kernel (stockham.cu: C2C along the last axis of f32 or
// bf16 planes) and the real pair kernels fft_last_r2c_kernel and
// ifft_last_c2r_kernel (real.cu).  One instance per length N and stage list
// (a template pack); a mode fixes what stage 0 reads and what the last stage
// writes, and every stage in between is the same code:
//   C2C  stage 0 reads a row of (re, im) planes, the last stage writes a
//        row of (re, im) planes with the scale;
//   R2C  stage 0 reads real rows 2p and 2p+1 as the real and imaginary
//        parts of one complex row z; the last stage leaves Z = FFT(z) in
//        natural order in the shared buffer the list leaves free, and after
//        one barrier the untangle writes the half spectra of both rows;
//   C2R  stage 0 builds the full spectrum of z = x1 + i x2 from the half
//        spectra of rows 2p and 2p+1; the last stage writes Re z to row 2p
//        and Im z to row 2p+1 with the scale.
// Included by stockham.cu and real.cu; internal linkage, as the headers it
// includes.
//
// Design.  The kernels are bytes-bound on this card: a complex element is
// read once and written once (16 B in f32), and ~5*log2(n) flops against
// 16 B is far below the FP32 ridge (67 TFLOP/s / 3.35 TB/s = 20 flop/B).  A
// kernel that walks a block's rows through shared memory stage by stage
// keeps memory idle while it computes and moves ~7 B of shared traffic for
// each byte of device memory; this body keeps the rows in registers.
//   1. Rows in registers, high radix.  A row of n points is taken by
//      TPR = n / R0 threads (R0 the first radix: 16 from n = 16 on, so each
//      thread holds V = 16 values; for n <= 8 one thread the row).  The
//      stage list is last_stages (ops/stockham_kernels.py): radix 16 while
//      it fits, then the rest of the power of two (2, 4 or 8), then the odd
//      factor (3, 5 or 7), so every Ns is a power of two.  Every power of
//      two up to 2048 takes at most two exchanges of shared memory and the
//      mixed lengths at most three (1536 = 16*16*2*3).  The list is a
//      template pack: every radix, Ns, butterfly count and twiddle offset is
//      a compile-time constant, and the butterflies are straight-line code.
//   2. Device memory straight into registers.  Stage 0 has Ns = 1, and
//      thread j of a row reads elements j + r*TPR (r < R0): neighbouring
//      threads on neighbouring addresses for every r, no staging through
//      shared memory.  The last stage has Ns = n/R and writes j + r*Ns,
//      coalesced the same way, with the scale.  All of a thread's loads are
//      issued before the first is used (16 KiB in flight a 128-thread block
//      in f32).  bf16 elements are read and written as 2-byte scalars in
//      the same pattern, so the planes need no alignment beyond their own.
//   3. Small blocks, many resident: LAST_BLOCK threads at most (rows of the
//      same length a block), __launch_bounds__ capping the registers at
//      65536 / (LAST_BLOCK * LAST_MIN_BLOCKS) = 128 so that ptxas spills
//      nothing; 4096 rows of 1024 points are 1024 blocks, and each SM
//      overlaps one block's loads with another's butterflies.
//   4. Exchanges: stage s writes its outputs to shared buffer s % 2, one
//      block barrier, stage s+1 reads them, so one barrier an exchange.  A
//      stage of radix R gives each thread ceil((n/R) / TPR) butterflies; a
//      thread past the last repeats it and only its stores are dropped.
//      Rows of n >= 512 are stored XOR-swizzled (word x at
//      x ^ ((x >> 4) & 31), within its 32-word group), shorter rows padded
//      one word every 16 (pitch n + n/16): both keep the stride-16 writes of
//      the radix-16 stages and the unit-stride reads free of bank conflicts
//      at every power of two (the mixed lengths' ragged odd stage leaves at
//      most three words a bank; tests/test_torch_port_last_rows.py counts).
//   5. The ragged last block reads its last valid row again and stores
//      nothing past B.
// Twiddles: the float64-generated table of the stage list (_stage_tables),
// as every kernel reads it; no sincospif.  The radix-16 butterfly is two
// levels of Dft<4> joined by the W16 rotations (cos/sin(pi/8) from float64).

#pragma once

#include "stockham_tile.cuh"
#include "radix.cuh"

namespace {

constexpr int LAST_BLOCK = 128;      // threads a block, at most
constexpr int LAST_MIN_BLOCKS = 4;   // resident blocks an SM, at least

// Compile-time geometry of the instance for length N whose first radix is
// R0: TPR threads a row, RPB rows a block, the shared row pitch and
// where word x of a row lies in it.
template <int N, int R0>
struct LastGeo {
  static constexpr int TPR = N / R0;
  static constexpr int RPB = TPR >= LAST_BLOCK ? 1 : LAST_BLOCK / TPR;
  static constexpr int THREADS = TPR * RPB;
  static constexpr bool SWIZZLE = N >= 512;
  static constexpr int PITCH = SWIZZLE ? N : N + N / 16;
  __device__ __forceinline__ static int at(int x) {
    return SWIZZLE ? x ^ ((x >> 4) & 31) : x + (x >> 4);
  }
};

// Shared memory of an instance with S stages: one f32 (re, im) buffer of
// RPB rows per exchange, two at most.
template <int N, int R0, int S>
constexpr size_t last_smem() {
  using G = LastGeo<N, R0>;
  return S < 2 ? 0 : (S < 3 ? 1 : 2) * 2 * sizeof(float) * G::RPB * G::PITCH;
}

// What stage 0 reads and the last stage writes (see the top of the file).
enum class LastMode { C2C, R2C, C2R };

// What a thread of a C2C kernel works on: its row (`off`, the first element
// of the row it reads; stores only when `valid`), its lane in the row, and
// its row's part of each shared buffer.
template <typename T>
struct LastIO {
  static constexpr LastMode MODE = LastMode::C2C;
  using Elem = T;
  const T* xr;
  const T* xi;
  T* yr;
  T* yi;
  size_t off;
  bool valid;
  int lane;
  float* sr[2];
  float* si[2];
  const float2* tw;
  float s;
  float scale;
};

// What a thread of a real pair kernel works on: its row of LastGeo is the
// pair p of real rows 2p and 2p+1 (f32).  `off` and `off2` are the first
// elements stage 0 reads of rows 2p and 2p+1 (x for R2C; the half-spectrum
// planes xr, xi for C2R), `out` and `out2` the first elements written of
// them (yr, yi for R2C; the real plane yr for C2R).  Where an odd B leaves
// row 2p+1 out, `valid2` is false, `off2` is `off` and the row counts as
// zero; `valid` is false for the pairs past the end of a ragged last block
// (they read the last pair again).  `packed`: the half spectra are n/2 bins
// wide, bin n/2 (real) in bin 0's imaginary slot; else n/2 + 1.
template <LastMode M>
struct RealIO : LastIO<float> {
  static constexpr LastMode MODE = M;
  size_t off2;
  size_t out;
  size_t out2;
  bool valid2;
  int packed;
};

// Stage 0 of C2R: element x = lane + r*TPR (TPR * R = N) of the spectrum of
// z = x1 + i x2, from bin k of the two half spectra.  For r < R/2, x < N/2:
// k = x and Z = X1 + i X2; for r >= R/2, x >= N/2: the descending run
// k = N - x and Z = conj X1 + i conj X2.  The imaginary parts of bins 0 and
// N/2 (lane 0 at r = 0 and r = R/2) count as zero, packed bin N/2 is bin 0's
// imaginary slot, and every address stays inside its row.
template <int N, int R>
__device__ __forceinline__ void c2r_load(const RealIO<LastMode::C2R>& io,
                                         int r, int x, float& zr, float& zi) {
  const bool mirror = 2 * r >= R;
  const int k = mirror ? N - x : x;
  const bool edge = io.lane == 0 && (r == 0 || 2 * r == R);
  const bool nyq = io.packed && io.lane == 0 && 2 * r == R;
  const float* pr = nyq ? io.xi : io.xr + k;
  const float* pi = io.xi + (edge ? 0 : k);
  const float x1r = __ldg(pr + io.off), x2r = __ldg(pr + io.off2);
  float x1i = __ldg(pi + io.off), x2i = __ldg(pi + io.off2);
  if (edge) x1i = x2i = 0.0f;
  const float y2r = io.valid2 ? x2r : 0.0f;
  const float y2i = io.valid2 ? x2i : 0.0f;
  zr = mirror ? x1r + y2i : x1r - y2i;
  zi = mirror ? y2r - x1i : x1i + y2r;
}

// Bin k of the untangled half spectra, with the scale: X1 -> row 2p,
// X2 -> row 2p+1 where it exists.
__device__ __forceinline__ void r2c_store(const RealIO<LastMode::R2C>& io,
                                          int k, float x1r, float x1i,
                                          float x2r, float x2i) {
  io.yr[io.out + k] = x1r * io.scale;
  io.yi[io.out + k] = x1i * io.scale;
  if (io.valid2) {
    io.yr[io.out2 + k] = x2r * io.scale;
    io.yi[io.out2 + k] = x2i * io.scale;
  }
}

// The R2C untangle of bins k < w from Z in natural order, word x of the
// pair's row at G::at(x) of (zr, zi):
//     X1[k] = (Z[k] + conj Z[-k]) / 2,   X2[k] = (Z[k] - conj Z[-k]) / (2i).
// Lane l takes bins l + i*TPR (N/2 = 8*TPR), coalesced along k; bin N/2 is
// its own mirror (X1 = Re Z[N/2], X2 = Im Z[N/2], both real): packed, it
// goes to bin 0's imaginary slots, narrow, lane 0 writes it as bin N/2.
template <class G, int N>
__device__ __forceinline__ void r2c_untangle(const RealIO<LastMode::R2C>& io,
                                             const float* zr,
                                             const float* zi) {
  constexpr int M = N / 2;
  static_assert(M % G::TPR == 0, "the untangle's rounds must be whole");
  if (!io.valid) return;
#pragma unroll
  for (int i = 0; i < M / G::TPR; ++i) {
    const int k = io.lane + i * G::TPR;
    const int a = G::at(k), c = G::at((N - k) & (N - 1));
    const float ar = zr[a], ai = zi[a], cr = zr[c], ci = zi[c];
    float x1i = 0.5f * (ai - ci), x2i = 0.5f * (cr - ar);
    if (i == 0 && io.packed && io.lane == 0) {
      x1i = zr[G::at(M)];
      x2i = zi[G::at(M)];
    }
    r2c_store(io, k, 0.5f * (ar + cr), x1i, 0.5f * (ai + ci), x2i);
  }
  if (!io.packed && io.lane == 0) {
    const int q = G::at(M);
    r2c_store(io, M, zr[q], 0.0f, zi[q], 0.0f);
  }
}

// The same for N <= 16, where one thread holds the whole row: Z[k] is
// (vr[k], vi[k]) after the one stage, so the untangle runs in registers.
template <int N>
__device__ __forceinline__ void r2c_untangle_regs(
    const RealIO<LastMode::R2C>& io, const float* vr, const float* vi) {
  constexpr int M = N / 2;
  if (!io.valid) return;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int c = (N - k) & (N - 1);
    float x1i = 0.5f * (vi[k] - vi[c]), x2i = 0.5f * (vr[c] - vr[k]);
    if (k == 0 && io.packed) {
      x1i = vr[M];
      x2i = vi[M];
    }
    r2c_store(io, k, 0.5f * (vr[k] + vr[c]), x1i, 0.5f * (vi[k] + vi[c]),
              x2i);
  }
  if (!io.packed) r2c_store(io, M, vr[M], 0.0f, vi[M], 0.0f);
}

// Stage ST of the list (radix R, Ns = NS, its twiddles at TWOFF), then the
// stages REST.  Butterfly j < M = N/R reads j + r*M (device memory at stage
// 0, as IO::MODE says; shared buffer (ST-1) % 2 after), twiddles by table
// entry TWOFF + (r-1)*NS + j%NS, runs an R-point DFT and writes
// (j - j%NS)*R + j%NS + r*NS (shared buffer ST % 2; at the last stage,
// where that is j + r*NS, device memory with the scale, or for R2C shared
// buffer ST % 2 and then the untangle).
template <class IO, class G, int N, int ST, int NS, int TWOFF, int R,
          int... REST>
__device__ __forceinline__ void last_stage(const IO& io) {
  using T = typename IO::Elem;
  constexpr LastMode MODE = IO::MODE;
  constexpr int M = N / R;
  constexpr int NB = (M + G::TPR - 1) / G::TPR;   // butterflies a thread
  constexpr bool EXACT = NB * G::TPR == M;
  float vr[NB][R], vi[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = EXACT ? io.lane + b * G::TPR
                        : min(io.lane + b * G::TPR, M - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (ST == 0 && MODE == LastMode::C2C) {
        vr[b][r] = to_f32(__ldg(io.xr + io.off + j + r * M));
        vi[b][r] = to_f32(__ldg(io.xi + io.off + j + r * M));
      } else if constexpr (ST == 0 && MODE == LastMode::R2C) {
        vr[b][r] = __ldg(io.xr + io.off + j + r * M);
        const float im = __ldg(io.xr + io.off2 + j + r * M);
        vi[b][r] = io.valid2 ? im : 0.0f;
      } else if constexpr (ST == 0) {
        c2r_load<N, R>(io, r, j + r * M, vr[b][r], vi[b][r]);
      } else {
        const int a = G::at(j + r * M);
        vr[b][r] = io.sr[(ST - 1) & 1][a];
        vi[b][r] = io.si[(ST - 1) & 1][a];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if constexpr (NS > 1) {
      const int j = EXACT ? io.lane + b * G::TPR
                          : min(io.lane + b * G::TPR, M - 1);
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
  if constexpr (sizeof...(REST) == 0 && MODE == LastMode::R2C && ST == 0) {
    static_assert(G::TPR == 1 && NS * R == N, "one thread the row");
    r2c_untangle_regs<N>(io, vr[0], vi[0]);
  } else if constexpr (sizeof...(REST) == 0 && MODE == LastMode::R2C) {
    static_assert(NS * R == N, "the stage list must multiply to N");
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = io.lane + b * G::TPR;
      if (EXACT || j < M) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int a = G::at(j + r * NS);
          io.sr[ST & 1][a] = vr[b][r];
          io.si[ST & 1][a] = vi[b][r];
        }
      }
    }
    __syncthreads();
    r2c_untangle<G, N>(io, io.sr[ST & 1], io.si[ST & 1]);
  } else if constexpr (sizeof...(REST) == 0) {
    static_assert(NS * R == N, "the stage list must multiply to N");
    if (io.valid) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = io.lane + b * G::TPR;
        if (EXACT || j < M) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if constexpr (MODE == LastMode::C2C) {
              io.yr[io.off + j + r * NS] = from_f32<T>(vr[b][r] * io.scale);
              io.yi[io.off + j + r * NS] = from_f32<T>(vi[b][r] * io.scale);
            } else {
              io.yr[io.out + j + r * NS] = vr[b][r] * io.scale;
              if (io.valid2)
                io.yr[io.out2 + j + r * NS] = vi[b][r] * io.scale;
            }
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = io.lane + b * G::TPR;
      if (EXACT || j < M) {
        const int k = j & (NS - 1);
        const int base = (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int a = G::at(base + r * NS);
          io.sr[ST & 1][a] = vr[b][r];
          io.si[ST & 1][a] = vi[b][r];
        }
      }
    }
    __syncthreads();
    last_stage<IO, G, N, ST + 1, NS * R, TWOFF + (R - 1) * NS, REST...>(io);
  }
}

template <int R0, int... RS>
__host__ __device__ constexpr int first_radix() {
  return R0;
}

// Points the thread's row at its part of the shared buffers: RPB rows of
// PITCH words a buffer, re part then im part, buffer 1 after buffer 0.
template <class G, class IO>
__device__ __forceinline__ void last_smem_rows(IO& io, float* smem, int rl) {
  constexpr int PART = G::RPB * G::PITCH;   // words of one buffer's re part
  io.sr[0] = smem + rl * G::PITCH;
  io.si[0] = io.sr[0] + PART;
  io.sr[1] = io.sr[0] + 2 * PART;
  io.si[1] = io.sr[1] + PART;
}

// One instance of a row kernel: length N, stage list R...
template <int N, int... R>
struct LastList {};

// Calls f(LastList<n, radices...>{}) for the instance of length n, the
// lengths kernel_len_ok(n, last=True) admits with their last_stages lists;
// cudaErrorInvalidValue for any other n.
template <class F>
cudaError_t with_last_list(int n, F&& f) {
#define LAST_CASE(n_, ...) \
  case n_: return f(LastList<n_, __VA_ARGS__>{});
  switch (n) {
    LAST_CASE(2, 2)
    LAST_CASE(4, 4)
    LAST_CASE(8, 8)
    LAST_CASE(16, 16)
    LAST_CASE(32, 16, 2)
    LAST_CASE(64, 16, 4)
    LAST_CASE(128, 16, 8)
    LAST_CASE(256, 16, 16)
    LAST_CASE(384, 16, 8, 3)
    LAST_CASE(512, 16, 16, 2)
    LAST_CASE(640, 16, 8, 5)
    LAST_CASE(768, 16, 16, 3)
    LAST_CASE(896, 16, 8, 7)
    LAST_CASE(1024, 16, 16, 4)
    LAST_CASE(1536, 16, 16, 2, 3)
    LAST_CASE(2048, 16, 16, 8)
    default: return cudaErrorInvalidValue;
  }
#undef LAST_CASE
}

// Whether the host's stage list is the instance's (the C-side check of
// last_stages).
template <int N, int... R>
bool last_list_ok(LastList<N, R...>, int nstages, const int* radices) {
  constexpr int S = sizeof...(R);
  constexpr int rad[S] = {R...};
  if (nstages != S) return false;
  for (int i = 0; i < S; ++i)
    if (radices[i] != rad[i]) return false;
  return true;
}

// The residency of a row kernel `fn` launched with `threads` threads, `rows`
// rows a block and `smem` shared bytes: out = {resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), rows a block, threads a
// block, registers a thread, shared bytes a block}.
inline cudaError_t last_residency_of(const void* fn, int threads, int rows,
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
  out[1] = rows;
  out[2] = threads;
  out[3] = attr.numRegs;
  out[4] = (int)smem;
  return cudaSuccess;
}

}  // namespace
