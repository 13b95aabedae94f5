// The thread-block cluster body of the two-axis kernels for Hopper
// (sm_90a): fft_fused2_kernel (stockham.cu: fft_fused2 and the gap pass)
// and fft_axes2_ring_kernel (ring.cu: the slab ring's fuse_last mode).  One
// (n1, n2) plane per cluster of C CTAs; CTA c holds the stripe of columns
// [c*w, (c+1)*w), w = n2/C, in its shared memory, and takes rows
// [c*h, (c+1)*h), h = n1/C, for the row pass, gathered through distributed
// shared memory.  Here: the geometry constants, the in-register butterfly
// stage over the stripe or the rows (f2_stage, dispatched on the radix by
// f2_stage_of), the stage list copied to shared memory (F2Stages), the
// distributed-shared-memory load, and the host's shared-memory size and
// cluster-occupancy query.  stockham.cu's note says how fft_fused2_kernel
// uses them.  Included after stockham_tile.cuh and radix.cuh; internal
// linkage, as they.

#pragma once

#include <mutex>

#include "stockham_tile.cuh"
#include "radix.cuh"

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

// Set the kernel's shared-memory and cluster attributes; then how many
// clusters of C CTAs with `smem` bytes each the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once per (kernel, C, smem) and
// kept.

cudaError_t fused2_clusters(const void* fn, int C, size_t smem, int* count) {
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
  cfg.blockDim = dim3(F2_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(count, fn, &cfg);
  if (e == cudaSuccess && nseen < 64) seen[nseen++] = {fn, C, smem, *count};
  return e;
}

}  // namespace
