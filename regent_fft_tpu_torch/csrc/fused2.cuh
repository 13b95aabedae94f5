// The thread-block cluster bodies of the two-axis kernels for Hopper
// (sm_90a).  One (n1, n2) plane per cluster of C CTAs; CTA c transforms the
// stripe of columns [c*w, (c+1)*w), w = n2/C, and then the rows
// [c*h, (c+1)*h), h = n1/C, which reach it through distributed shared
// memory.  Two bodies:
//   - the stage walk (fft_fused2_kernel in stockham.cu: fft_fused2 at the
//     geometries the register body has no instance for, and the gap pass;
//     fft_axes2_ring_kernel in ring.cu: the slab ring's fuse_last mode): the
//     geometry constants, the in-register butterfly stage over a stripe or
//     rows held in shared memory (f2_stage, dispatched on the radix by
//     f2_stage_of), the stage list copied to shared memory (F2Stages), the
//     distributed-shared-memory load, the shared-memory size;
//   - the register body (fft_fused2_regs_kernel in stockham.cu: fft_fused2):
//     cols.cuh's column recursion with one buffer on both axes
//     (f2_regs_stage), the column pass's last stage storing into the owning
//     CTA's row buffer (F2ColIO; F2ColIlIO reads interleaved complex64
//     input), the row pass reading it (F2RowIO); its geometry (F2Geo) and
//     instance table (with_f2_geo).
// Both share the host's cluster-occupancy query.  stockham.cu's notes say
// how the kernels use them.  Included after stockham_tile.cuh and
// radix.cuh; internal linkage, as they.

#pragma once

#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "stockham_tile.cuh"
#include "radix.cuh"
#include "last.cuh"

namespace {

constexpr int F2_THREADS = 512;
constexpr int F2_CTA_ELEMS = 16384;   // elements of a plane a CTA holds
constexpr int F2_GROUPS = F2_CTA_ELEMS / 4 / F2_THREADS;   // 4-element loads
constexpr int F2_ELEMS = F2_CTA_ELEMS / F2_THREADS;  // values a stage holds
constexpr int F2_MAX_CLUSTER = 16;
constexpr int F2_MAX_SMEM = 232448;

__device__ __forceinline__ int div_by(int u, int d) {
  return (d & (d - 1)) ? u / d : u >> (__ffs(d) - 1);
}

// The CTA's shared memory holds, in each of its re and im parts, the stripe,
// element (row j, column t) at j*w + t, and the rows from word RB = h*n2/2
// on: element (row t, i) at RB + X + X/32 with X = t*n2 + i (n2 % 32 == 0,
// so that is a row pitch of n2 + n2/32, one pad word every 32: the strided
// butterfly writes stay free of bank conflicts).  The rows' upper half lies
// past the stripe, so the gather writes it at once; the lower half covers
// the stripe's upper half and waits for the cluster.  A stage names an
// element by its unpadded index X; f2_pad<true> pads it.
template <bool PAD>
__device__ __forceinline__ int f2_pad(int x) {
  return PAD ? x + (x >> 5) : x;
}

// One in-place stage of radix R over `ntr` transforms of m*R points in the
// CTA's shared memory (sr, si: the stripe, or the rows at RB).  Butterfly
// u is (transform t, butterfly j): t = u % ntr, j = u / ntr in the stripe
// (COLS: neighbouring threads on neighbouring columns; element i of
// transform t at X = i*w + t), t = u / m, j = u % m in the rows
// (X = t*n2 + i).  A CTA holds at most F2_CTA_ELEMS elements, so thread
// tid takes butterflies tid + b*F2_THREADS, b < MAXB, about ELEMS values
// (F2_ELEMS; fewer where a stage covers part of the stripe).
// Every butterfly is read, twiddled and transformed; then, after a block
// barrier when `sync` (st writes shared memory), st(X, re, im) writes its
// outputs, output r at xo + r*ns*(COLS ? w : 1): xo is all that stays live
// of a butterfly's indices.  The code is straight-line for every b: a
// thread past the last butterfly repeats it and only its stores are
// dropped (branches around the butterflies made the compiler spill them).
template <int R, bool COLS, int ELEMS = F2_ELEMS, class St>
__device__ __forceinline__ void f2_stage(const float* sr, const float* si,
                                         int ld, int ntr, int m, int lns,
                                         const float2* __restrict__ tw,
                                         float s, const St& st, bool sync) {
  constexpr int MAXB = (ELEMS + R - 1) / R;
  const int total = ntr * m, ns = 1 << lns;
  const int step = COLS ? m * ld : m, ostep = COLS ? ns * ld : ns;
  float vr[MAXB][R], vi[MAXB][R];
  int xo[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    const int u = min(threadIdx.x + b * F2_THREADS, total - 1);
    const int q = div_by(u, COLS ? ntr : m);
    const int t = COLS ? u - q * ntr : q, j = COLS ? q : u - q * m;
    const int x = COLS ? j * ld + t : t * ld + j;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = f2_pad<!COLS>(x + r * step);
      vr[b][r] = sr[a];
      vi[b][r] = si[a];
    }
    const int k = j & (ns - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) {   // the first stage's entries are 1
      const float2 w = __ldg(&tw[(r - 1) * ns + k]);
      const float xr = vr[b][r], xi = vi[b][r];
      vr[b][r] = fmaf(xr, w.x, -xi * w.y);
      vi[b][r] = fmaf(xr, w.y, xi * w.x);
    }
    Dft<R>::run(vr[b], vi[b], s);
    const int base = (j - k) * R + k;
    xo[b] = COLS ? base * ld + t : t * ld + base;
  }
  if (sync) __syncthreads();
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
    if (threadIdx.x + b * F2_THREADS < total) {
#pragma unroll
      for (int r = 0; r < R; ++r) st(xo[b] + r * ostep, vr[b][r], vi[b][r]);
    }
}

// The stage list of one axis, copied to shared memory at the start of the
// kernel so that the stage loop indexes it there, not the kernel
// parameters (which a run-time index would copy to local memory).
struct F2Stages {
  int n, nstages;
  int radix[MAX_STAGES], lns[MAX_STAGES], twoff[MAX_STAGES];
};

__device__ __forceinline__ void f2_copy(F2Stages& d, const StagePlan& q) {
  d.n = q.n;
  d.nstages = q.nstages;
#pragma unroll
  for (int i = 0; i < MAX_STAGES; ++i) {
    d.radix[i] = q.radix[i];
    d.lns[i] = q.lns[i];
    d.twoff[i] = q.twoff[i];
  }
}

// Stage `st` of an axis, dispatched on its radix.
template <bool COLS, int ELEMS = F2_ELEMS, class St>
__device__ __forceinline__ void f2_stage_of(const F2Stages& p, int st,
                                            const float* sr, const float* si,
                                            int ld, int ntr,
                                            const float2* __restrict__ tw,
                                            float s, const St& sto, bool sync) {
  const int r = p.radix[st], m = p.n / r, lns = p.lns[st];
  const float2* tws = tw + p.twoff[st];
#define F2_STAGE(R) \
  f2_stage<R, COLS, ELEMS>(sr, si, ld, ntr, m, lns, tws, s, sto, sync)
  switch (r) {
    case 2: F2_STAGE(2); break;
    case 3: F2_STAGE(3); break;
    case 4: F2_STAGE(4); break;
    case 5: F2_STAGE(5); break;
    case 7: F2_STAGE(7); break;
    default: F2_STAGE(8); break;
  }
#undef F2_STAGE
}

// The address, in the cluster's shared window (32 bits), of the word of
// CTA `rank`'s shared memory at the offset of `p` in this CTA's; and a
// 16-byte load from such an address (distributed shared memory).
__device__ __forceinline__ unsigned f2_remote(const float* p, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 f2_ld_remote(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// The cluster kernel's shared memory for (n1, n2) planes in clusters of C,
// or 0 when the geometry is not one the kernel takes: C a power of two
// <= F2_MAX_CLUSTER that divides n1, n2 a multiple of 8*C (the stripe width
// w a multiple of 8, for the 16-byte loads), at most F2_CTA_ELEMS elements
// a CTA, and its h = n1/C padded rows, half a stripe below them, within
// F2_MAX_SMEM.
size_t fused2_smem(int n1, int n2, int C) {
  if (C < 1 || C > F2_MAX_CLUSTER || (C & (C - 1)) || n1 < 1 || n2 < 1
      || n1 % C || n2 % (8 * C) || (long long)n1 * n2 / C > F2_CTA_ELEMS)
    return 0;
  const size_t hn = (size_t)(n1 / C) * n2;   // elements of the CTA's rows
  const size_t bytes = 2 * sizeof(float) * (hn / 2 + hn + hn / 32);
  return bytes + 2 * sizeof(F2Stages) <= F2_MAX_SMEM ? bytes : 0;
}

// --------------------------------------------------------------------------
// The register body (fft_fused2_regs_kernel).

// The column pass: W neighbouring columns of N points, E values a thread,
// thread t on lane t / W of column t % W (cols.cuh's layout: a warp reads
// 32 neighbouring columns of a row), element x of column `col` of the
// exchange at x*W + col (W >= 32: a warp's accesses on 32 banks).
template <int N_, int E, int W>
struct F2ColGeo {
  static constexpr int N = N_;
  static constexpr int TPC = N / E;              // threads a column
  static constexpr int THREADS = TPC * W;
  static_assert(TPC * E == N && W >= 32 && W % 32 == 0, "column geometry");
  __device__ __forceinline__ static int at(int x, int col) {
    return x * W + col;
  }
};

// The row pass: H rows of N points, E values a thread, thread t on lane
// t % TPC of row t / TPC (last.cuh's layout: neighbouring lanes on
// neighbouring elements), so the last stage's stores are coalesced along
// the row.  Element x of row `row` lies at row*PITCH + x + x/32, one pad
// word every 32, PITCH = N + N/32: with the instances' lists (32, N/32)
// the radix-32 writes (stride 32, 33 words apart), the unit-stride reads
// and the column pass's stores (32 consecutive x of one row a warp) fall
// on distinct banks, the RW rows a warp spans PITCH = 32/RW (mod 32)
// apart (tests/test_torch_port_fused2_cluster.py counts).  For x = j + c
// with c a multiple of 32 the word is j's plus a constant, so a stage's
// accesses differ by immediate offsets.
template <int N_, int E, int H>
struct F2RowGeo {
  static constexpr int N = N_;
  static constexpr int TPC = N / E;              // threads a row
  static constexpr int THREADS = TPC * H;
  static constexpr int RW = TPC >= 32 ? 1 : 32 / TPC;   // rows a warp
  static constexpr int PITCH = N + N / 32;
  static_assert(TPC * E == N && N % 32 == 0 && PITCH % 32 == 32 / RW % 32,
                "row geometry");
  __device__ __forceinline__ static int at(int x, int row) {
    return row * PITCH + x + (x >> 5);
  }
};

// A 32-bit shared address of this CTA mapped to CTA `rank` of the cluster,
// and a 4-byte store there (distributed shared memory).  The mapping is
// volatile so that it is made where the store needs it: hoisted out of the
// plane loop, the 32 addresses a thread stores to stay live across it and
// spill.
__device__ __forceinline__ unsigned f2_mapa(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void f2_st_remote(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// The thread's index, read anew where it is asked for: the persistent
// loop's addresses depend on it and are then made in each plane, not
// hoisted out of the loop and spilled (a few integer instructions a plane
// against the local-memory traffic of ~40 live addresses).
__device__ __forceinline__ int f2_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Stage ST of the list (radix R, Ns = NS, its twiddles at TWOFF), then the
// stages REST, over the lines (columns or rows) of geometry G: thread
// (io.line, io.lane) takes butterflies j = lane + b*TPC, b < N/R/TPC (whole
// butterflies: every instance's radices divide E).  Butterfly j reads
// element j + r*M (M = N/R; stage 0 from io.load, later stages from the
// CTA's one exchange buffer io.sr/io.si in G's layout), twiddles by table
// entry TWOFF + (r-1)*NS + j%NS, runs an R-point DFT and writes
// (j - j%NS)*R + j%NS + r*NS to the buffer, between two block barriers (the
// first: every thread has read the buffer, at stage 0 the previous user's
// reads), or at the last stage, where that is j + r*NS, hands it to
// io.store after io.begin_store().  The body is cols.cuh's cols_stage with
// one buffer and both passes' IO.
template <class IO, class G, int ST, int NS, int TWOFF, int R, int... REST>
__device__ __forceinline__ void f2_regs_stage(const IO& io) {
  constexpr int M = G::N / R;
  constexpr int NB = M / G::TPC;                 // butterflies a thread
  static_assert(NB * G::TPC == M, "whole butterflies a thread");
  float vr[NB][R], vi[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = io.lane + b * G::TPC;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (ST == 0) {
        io.load(j + r * M, vr[b][r], vi[b][r]);
      } else {
        const int a = G::at(j + r * M, io.line);
        vr[b][r] = io.sr[a];
        vi[b][r] = io.si[a];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if constexpr (NS > 1) {
      const int k = (io.lane + b * G::TPC) & (NS - 1);
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
    io.begin_store();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        io.store(io.lane + b * G::TPC + r * NS, vr[b][r], vi[b][r]);
    }
  } else {
    __syncthreads();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = io.lane + b * G::TPC, k = j & (NS - 1);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = G::at(base + r * NS, io.line);
        io.sr[a] = vr[b][r];
        io.si[a] = vi[b][r];
      }
    }
    __syncthreads();
    f2_regs_stage<IO, G, ST + 1, NS * R, TWOFF + (R - 1) * NS, REST...>(io);
  }
}

// What a thread of either pass works on: its line and lane, the CTA's
// buffer (re and im parts), the stage list's twiddles, the sign.
struct F2IO {
  int line;
  int lane;
  float* sr;
  float* si;
  const float2* tw;
  float s;
};

// The column pass's IO: stage 0 reads element x of the thread's column of
// the plane from device memory (rows LD elements apart); the last stage
// sends element k to row k % H of CTA k / H of the cluster (GR's layout, at
// column c*w + the thread's column), after the cluster barrier of
// begin_store(): every CTA has then read its column exchange, whose buffer
// its rows reuse.
template <typename T, class GR, int LD, int H>
struct F2ColIO : F2IO {
  const T* xr;
  const T* xi;
  size_t off;       // element 0 of the thread's column
  unsigned rows;    // shared address of this CTA's buffer (re part)
  unsigned imoff;   // bytes from the re part to the im part
  int x;            // the thread's column in the plane
  __device__ __forceinline__ void load(int k, float& re, float& im) const {
    const size_t o = off + (size_t)k * LD;
    re = to_calc(__ldg(xr + o));
    im = to_calc(__ldg(xi + o));
  }
  __device__ __forceinline__ void begin_store() const {
    cooperative_groups::this_cluster().sync();
  }
  __device__ __forceinline__ void store(int k, float re, float im) const {
    const unsigned a = f2_mapa(rows + 4u * GR::at(x, k % H), k / H);
    f2_st_remote(a, re);
    f2_st_remote(a + imoff, im);
  }
};

// The column pass's IO on interleaved complex64 input (fft_fused2's
// interleaved entry): element x of the thread's column is the (re, im) pair
// at pair off + x*LD of the caller's tensor, xr its first word, one 8-byte
// load (a warp's 32 neighbouring columns: 256 contiguous bytes).  Only the
// load differs from F2ColIO.
template <class GR, int LD, int H>
struct F2ColIlIO : F2ColIO<float, GR, LD, H> {
  __device__ __forceinline__ void load(int k, float& re, float& im) const {
    const float2 v = __ldg(reinterpret_cast<const float2*>(this->xr)
                           + this->off + (size_t)k * LD);
    re = v.x;
    im = v.y;
  }
};

// The row pass's IO: stage 0 reads element x of the thread's row from the
// buffer; the last stage writes element k to device memory with the
// scale (the row's first element at `off`).
template <typename T, class G>
struct F2RowIO : F2IO {
  T* yr;
  T* yi;
  size_t off;
  float scale;
  __device__ __forceinline__ void load(int k, float& re, float& im) const {
    const int a = G::at(k, line);
    re = sr[a];
    im = si[a];
  }
  __device__ __forceinline__ void begin_store() const {}
  __device__ __forceinline__ void store(int k, float re, float im) const {
    yr[off + k] = from_calc<T>(re * scale);
    yi[off + k] = from_calc<T>(im * scale);
  }
};

// An instance of the register body: cluster size C, E values a thread on
// both axes, the stage lists L1 = LastList<n1, R1...> of the columns and
// L2 = LastList<n2, R2...> of the rows (fused2_regs_stages').
template <int C_, int E_, class L1, class L2>
struct F2Geo;
template <int C_, int E_, int N1_, int... R1, int N2_, int... R2>
struct F2Geo<C_, E_, LastList<N1_, R1...>, LastList<N2_, R2...>> {
  static constexpr int C = C_, E = E_, N1 = N1_, N2 = N2_;
  static constexpr int W = N2 / C, H = N1 / C;
  using G1 = F2ColGeo<N1, E, W>;
  using G2 = F2RowGeo<N2, E, H>;
  static constexpr int THREADS = G1::THREADS;
  // one f32 (re, im) buffer: the column exchange (n1*w words a part),
  // then the rows (h padded rows)
  static constexpr int PART = H * G2::PITCH;
  static_assert(PART >= N1 * W, "the rows cover the column exchange");
  static constexpr size_t SMEM = 2 * sizeof(float) * PART;
  static_assert(N1 % C == 0 && N2 % C == 0 && G2::THREADS == THREADS
                && THREADS <= 1024 && SMEM <= F2_MAX_SMEM, "F2Geo");
  // the column pass's IO: planes, or with IL the interleaved input (f32)
  template <typename T, bool IL = false>
  using ColIO = std::conditional_t<IL, F2ColIlIO<G2, N2, H>,
                                   F2ColIO<T, G2, N2, H>>;
  template <typename T>
  using RowIO = F2RowIO<T, G2>;
  template <class IO>
  __device__ __forceinline__ static void cols(const IO& io) {
    f2_regs_stage<IO, G1, 0, 1, 0, R1...>(io);
  }
  template <class IO>
  __device__ __forceinline__ static void rows(const IO& io) {
    f2_regs_stage<IO, G2, 0, 1, 0, R2...>(io);
  }
  // are the host's stage lists the instance's?
  static bool lists_ok(int ns1, const int* r1, int ns2, const int* r2) {
    return last_list_ok(LastList<N1, R1...>{}, ns1, r1)
           && last_list_ok(LastList<N2, R2...>{}, ns2, r2);
  }
};

// Calls f(F2Geo<...>{}) for the register body's instance at (n1, n2, C);
// cudaErrorInvalidValue where it has none (the stage walk runs there).
// ops/stockham_kernels.py:FUSED2_REGS mirrors this table, and
// fused2_regs_stages the lists.
template <class F>
cudaError_t with_f2_geo(int n1, int n2, int C, F&& f) {
  using L256 = LastList<256, 32, 8>;
  using L512 = LastList<512, 32, 16>;
  //                             n1   n2   C         C   E
  if (n1 == 512 && n2 == 512 && C == 16) return f(F2Geo<16, 32, L512, L512>{});
  if (n1 == 256 && n2 == 256 && C == 4) return f(F2Geo<4, 32, L256, L256>{});
  return cudaErrorInvalidValue;
}

// Set the kernel's shared-memory and cluster attributes; then how many
// clusters of C CTAs with `smem` bytes each the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once per (kernel, C, smem) and
// kept.

cudaError_t fused2_clusters(const void* fn, int C, size_t smem, int* count,
                            int threads = F2_THREADS) {
  static std::mutex mu;
  static struct { const void* fn; int C; size_t smem; int count; } seen[64];
  static int nseen = 0;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < nseen; ++i)
    if (seen[i].fn == fn && seen[i].C == C && seen[i].smem == smem) {
      *count = seen[i].count;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(count, fn, &cfg);
  if (e == cudaSuccess && nseen < 64) seen[nseen++] = {fn, C, smem, *count};
  return e;
}

}  // namespace
