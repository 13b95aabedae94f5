// Matmul-form DFT kernels for Hopper (sm_90a) on split re/im f32 planes:
//
//   fft_mm_kernel<false>  (C entry fft_mm1) replaces
//                         regent_fft_tpu/ops/pallas_fft.py:_runner_1stage
//   fft_mm_kernel<true>   (C entry fft_mm2) replaces
//                         regent_fft_tpu/ops/pallas_fft.py:_runner_2stage
//
// fft_mm1: y = x . D_n on (B, n) rows, n <= 128, D_n[j, k] = W_n^{j*k}.
// fft_mm2: the fused two-stage four-step on (B, n) rows, n = n1 * n2: the row
// viewed as X[nu1][nu2] (nu = nu1 * n2 + nu2), A[k1][nu2] = sum_nu1
// X[nu1][nu2] W_n1^{nu1*k1}, times the twiddle W_n^{nu2*k1}, then C[k1][k2] =
// sum_nu2 A[k1][nu2] W_n2^{nu2*k2}, written to y[k1 + n1 * k2].  fft_mm1 is
// the same kernel with n1 = 1 (no first stage, no twiddle).
//
// Bound on H100.  The function is bytes-bound (16 B a complex element each
// way against ~5 log2 n flops), but these are dense products, 8*n^2 flops a
// row for fft_mm1 and 8*n*(n1 + n2) + 6*n for fft_mm2: 262-1024 flops a
// complex element.  At the FP32 FFMA rate (67 TFLOP/s) that alone is 1.2-3.2x
// the bytes bound at the main path's shapes, so the products run on the
// tensor cores in a 3xTF32 split: each f32 operand a is split once, hi =
// cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), and every real product is
// lo*hi' + hi*lo' + hi*hi' by mma.sync.m16n8k8.tf32 with f32 accumulation
// (the dropped lo*lo' and the rounding of lo are ~2^-22 of a product; on an
// H100 rel_l2 at most 2.6e-7 against float64 and 3.9e-7 against the plain
// f32 versions over chip_smoke.py's sweeps).  Never plain TF32.  A complex product is four real ones
// (Dr Xr - Di Xi, Dr Xi + Di Xr), as the JAX _cdot_mid/_cdot_last; no 3M,
// which changes the error.  What bounds the kernels now is the mma issue
// around the products, not bytes (PERF.md).
//
// Design.  Every stage is the contraction Y[col][k] = sum_j W_L^{jk}
// X[col][j] over the columns of a tile of R rows held in shared memory: the
// DFT matrix is the mma A operand (M = outputs k, K = inputs j), the data the
// B operand (N = columns).  Where it saves products (mm_halves: even L past
// 16) a stage first takes one radix-2 step in place and contracts the sums
// and the differences over L/2, half the products.  A warp unit is MT 16-row
// m-tiles by NT 8-column n-tiles (MT * NT = 6); for each K step of 8 the
// warp builds its A fragments once from the L-entry root table (the f32
// roots of _device_roots, generated in float64 and rounded once, so D holds
// the JAX tables' values bit for bit), element W_L^{(k*j) mod L} with the
// exponents carried by additions, splits them and reuses them across its NT
// n-tiles (12 mma each).  Each K step's products go to a zeroed fragment
// that an f32 add then takes into the accumulator, so the tensor core never
// carries a long sum (its own accumulation truncates, and over a long sum
// the error grew several times).  Building D from the
// n-entry table, not storing it, is what fits n = 128: a stored Dr, Di in
// f32 is 128 KB (256 KB split), which left fft_mm1 at 128 no room for two
// row tiles and fft_mm2 at (128, 128) none for its 128 KB row.  K and M are
// padded to 8 and 16 in registers only: the last K step masks D to 0 past
// the depth and clamps the data index, so no pad is read as data.
//
// Rows: tile row r's X[nu1][nu2] at r * RS + nu1 * P + nu2 (P = ceil8(n2) +
// 4, RS = n1 * P); fft_mm2's first stage writes its twiddled outputs
// A[k1][nu2] in place at r * RS + k1 * P + nu2, the second stage its outputs
// in output order from r * RS, and the tile leaves in 16-byte stores
// (scalar where n % 4 or the pointers forbid).  Each warp holds one unit's
// accumulators; a stage with more units than warps runs in rounds of whole
// column groups (in place is safe: a round's columns are its own), and then
// the last stage stores straight from the accumulators.  Persistent CTAs,
// one an SM (the kernel takes over 128 registers a thread), walk over row
// tiles; with two buffers, tile t+1 arrives by 16-byte cp.async (4-byte
// where n2 % 4) while tile t's products run.  ops/pallas_fft.py:mm_geometry
// picks R, the buffers, the CTAs and the shared memory; the C entries check
// them again.
//
// Conventions: kernels launch on the caller's stream, never synchronise and
// allocate nothing; each C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or geometry it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MM_THREADS = 256;
constexpr int MM_WARPS = MM_THREADS / 32;
constexpr int MM_UNIT_TILES = 6;       // accumulator tiles (16 x 8) a warp
constexpr int MM_MAX_N = 128;          // largest DFT length of one stage
constexpr size_t MM_SMEM_MAX = 232448; // 227 KB, the per-block limit

__host__ __device__ inline int mm_pitch(int n2) {
  return (n2 + 7) / 8 * 8 + 4;
}

// Dynamic shared memory: `nb` buffers of R regions of n1 * P floats, re and
// im, then the roots of n1 and of n2 as (re, im) pairs.
__host__ __device__ inline size_t mm_smem(int n1, int n2, int R, int nb) {
  return sizeof(float) *
         ((size_t)nb * 2 * R * n1 * mm_pitch(n2) + 2 * (size_t)(n1 + n2));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floor(c / d) for 0 <= c < 2^18, 1 <= d <= 2^14: one multiply-high by
// m = ceil(2^32 / d) (exact while c * (m * d - 2^32) < 2^32).
// d = 1, whose m is 2^32, takes c itself.
struct Div {
  unsigned m, one;
  __device__ __forceinline__ explicit Div(int d)
      : m(d > 1 ? (unsigned)((0x100000000ULL + d - 1) / d) : 0u),
        one(d > 1 ? 0u : ~0u) {}
  __device__ __forceinline__ int operator()(int c) const {
    return (int)(__umulhi((unsigned)c, m) + ((unsigned)c & one));
  }
};

// 3xTF32 operand: the tf32 rounding of a and of the remainder.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ Split split(float a) {
  const uint32_t hi = tf32(a);
  return {hi, tf32(a - __uint_as_float(hi))};
}

__device__ __forceinline__ Split neg(Split s) {
  return {s.hi ^ 0x80000000u, s.lo ^ 0x80000000u};
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b (C = 0).
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d = a * b in 3xTF32 (d += where `add`): the small terms first, then
// hi * hi.
template <bool add>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], Split b0,
                                     Split b1) {
  if (add)
    mma(d, alo, b0.hi, b1.hi);
  else
    mma0(d, alo, b0.hi, b1.hi);
  mma(d, ahi, b0.lo, b1.lo);
  mma(d, ahi, b0.hi, b1.hi);
}

// A stage's columns: column c's element j at (c / cw) * RS + (c % cw) * cs
// + j * js in each plane, for c < ncols.
struct Cols {
  int ncols, cw, RS, cs, js;
  Div dcw;
  __device__ __forceinline__ int base(int c) const {
    const int r = dcw(c);
    return r * RS + (c - r * cw) * cs;
  }
};

// One stage: the L-point DFT of every column.  Where mm_halves(L) the
// columns first take one radix-2 step in place (x[j], x[j + L/2] -> their
// sum and difference), since W_L^{(j + L/2) k} = (-1)^k W_L^{jk}: output
// k = 2m + par is then the contraction of the sums (par 0) or differences
// (par 1) over j < H = L/2 with W_L^{k j}.  Else H = L, one parity, k = m.
struct Spec {
  int L, H, np;
  Cols cl;
};

// The radix-2 step is taken where it saves mma: an even L whose two half
// contractions take fewer (m-tile, K step) pairs than the whole one (not at
// L = 16, whose halves still fill a 16-row m-tile each).
__host__ __device__ inline bool mm_halves(int L) {
  const int H = L / 2;
  return L % 2 == 0 &&
         2 * ((H + 15) / 16) * ((H + 7) / 8) < ((L + 15) / 16) * ((L + 7) / 8);
}

__host__ __device__ inline Spec make_spec(int L, Cols cl) {
  const bool h = mm_halves(L);
  return {L, h ? L / 2 : L, h ? 2 : 1, cl};
}

// Unit shape: MT 16-row m-tiles by NT 8-column n-tiles, MM_UNIT_TILES
// accumulator tiles a warp (MT = 2, NT = 3 past a depth of 16; MT = 1,
// NT = 6 up to it).
__host__ __device__ inline int mm_mt(int H) { return H > 16 ? 2 : 1; }

// Units of one column group (parities x m-groups): a round needs them all.
__host__ __device__ inline int mm_group(int L) {
  const int H = mm_halves(L) ? L / 2 : L, np = mm_halves(L) ? 2 : 1;
  return np * ((H + 16 * mm_mt(H) - 1) / (16 * mm_mt(H)));
}

// Units of a stage over ncols columns: column groups of 8 NT columns.
__host__ __device__ inline int mm_units(int L, int ncols) {
  const int nt = MM_UNIT_TILES / mm_mt(mm_halves(L) ? L / 2 : L);
  return mm_group(L) * ((ncols + 8 * nt - 1) / (8 * nt));
}

// The radix-2 step of an even stage over every column of the tile.
__device__ void halve(float* sr, float* si, const Spec& sp) {
  const Cols& cl = sp.cl;
  const int H = sp.H;
  const int total = cl.ncols * H;
  const Div by(cl.js == 1 ? H : cl.ncols);
  for (int q = threadIdx.x; q < total; q += MM_THREADS) {
    int c, j;   // neighbouring threads on neighbouring addresses
    if (cl.js == 1) {
      c = by(q);
      j = q - c * H;
    } else {
      j = by(q);
      c = q - j * cl.ncols;
    }
    const int o = cl.base(c) + j * cl.js, o2 = o + H * cl.js;
    const float ar = sr[o], br = sr[o2], ai = si[o], bi = si[o2];
    sr[o] = ar + br;
    sr[o2] = ar - br;
    si[o] = ai + bi;
    si[o2] = ai - bi;
  }
  __syncthreads();
}

// One warp unit of parity `par`: acc[mi][nt][re/im] = sum_{j < H}
// W_L^{k*j} X[c][par*H + j] for the outputs k = np*m + par, m = m0 + 16 mi +
// (g, g + 8), and the columns c = c0 + 8 nt + (2t, 2t + 1) of the mma C
// fragment (g = lane / 4, t = lane % 4).  `w`: the L roots.  Each K step's
// products go to a zeroed fragment first and then into acc by an f32 add,
// so the tensor core's own accumulation never carries a long sum.
template <int MT, int NT>
__device__ __forceinline__ void contract(const float* sr, const float* si,
                                         const float2* w, const Spec& sp,
                                         int par, int m0, int c0,
                                         float (&acc)[MT][NT][2][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = sp.L, H = sp.H;
  const Cols& cl = sp.cl;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nt][p][q] = 0.0f;
  // A fragment a_q = W_L^{k j}, k = np * (m0 + 16 mi + g (+ 8 for q odd)) +
  // par, j = j0 + t (+ 4 for q >= 2): root (k * j) mod L, stepped by 8k
  int e[MT][4], inc[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = sp.np * (m0 + 16 * mi + g + 8 * h) + par;
      inc[mi][h] = (8 * k) % L;
      e[mi][h] = (k * t) % L;
      e[mi][h + 2] = (k * (t + 4)) % L;
    }
  }
  const int ksteps = (H + 7) / 8;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    const int j0 = 8 * ks;
    const bool tail = j0 + 8 > H;
    uint32_t rh[MT][4], rl[MT][4], ih[MT][4], il[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 v = w[e[mi][q]];
        if (tail && j0 + t + (q >= 2 ? 4 : 0) >= H) v = make_float2(0.f, 0.f);
        const Split a = split(v.x), b = split(v.y);
        rh[mi][q] = a.hi;
        rl[mi][q] = a.lo;
        ih[mi][q] = b.hi;
        il[mi][q] = b.lo;
        const int s = e[mi][q] + inc[mi][q & 1];
        e[mi][q] = s >= L ? s - L : s;
      }
    }
    // past H (the last step only) D is 0 and the data index is clamped
    const int ja = tail ? min(j0 + t, H - 1) : j0 + t;
    const int jb = tail ? min(j0 + t + 4, H - 1) : j0 + t + 4;
    // B fragment rows ja, jb of column c0 + 8 nt + g; a column past the
    // tile reads column 0 (its outputs are never stored)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = c0 + 8 * nt + g;
      const int cb = cl.base(c < cl.ncols ? c : 0) + par * H * cl.js;
      const int oa = cb + ja * cl.js, ob = cb + jb * cl.js;
      const Split br0 = split(sr[oa]), br1 = split(sr[ob]);
      const Split bi0 = split(si[oa]), bi1 = split(si[ob]);
      const Split nb0 = neg(bi0), nb1 = neg(bi1);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float pr[4], pi[4];
        mma3<false>(pr, rh[mi], rl[mi], br0, br1);   // Dr Xr
        mma3<true>(pr, ih[mi], il[mi], nb0, nb1);    // - Di Xi
        mma3<false>(pi, rh[mi], rl[mi], bi0, bi1);   // Dr Xi
        mma3<true>(pi, ih[mi], il[mi], br0, br1);    // Di Xr
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[mi][nt][0][q] += pr[q];
          acc[mi][nt][1][q] += pi[q];
        }
      }
    }
  }
}

// Which stage of the tile a contraction serves.
enum Stage { FIRST, SECOND };

struct Tile {
  float* sr;       // re and im planes of the tile's buffer
  float* si;
  int rows;        // valid rows (the last tile is ragged)
  long long row0;
  bool direct;     // the last stage stores straight to device memory
};

// Run one stage over the tile in rounds of whole column groups, one unit a
// warp, writing each round's outputs after every warp has read its inputs.
template <int MT, Stage S>
__device__ void stage(const Tile& tl, const float2* w, const Spec& sp,
                      int n1, int n2, int P, const float2* __restrict__ twg,
                      float* __restrict__ yr, float* __restrict__ yi) {
  constexpr int NT = MM_UNIT_TILES / MT;
  const Cols& cl = sp.cl;
  const int mg = (sp.H + 16 * MT - 1) / (16 * MT);
  const int pm = sp.np * mg;   // units of one column group
  const int ng = (cl.ncols + 8 * NT - 1) / (8 * NT);
  const int units = pm * ng;
  const int per_round = MM_WARPS / pm * pm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = n1 * n2;
  if (sp.np == 2) halve(tl.sr, tl.si, sp);
#pragma unroll 1
  for (int u0 = 0; u0 < units; u0 += per_round) {
    const int u = u0 + warp;
    const bool act = warp < per_round && u < units;
    const int in = u % pm;
    const int par = in / mg;
    const int m0 = 16 * MT * (in - par * mg), c0 = 8 * NT * (u / pm);
    float acc[MT][NT][2][4];
    if (act) contract<MT, NT>(tl.sr, tl.si, w, sp, par, m0, c0, acc);
    __syncthreads();
    if (act) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = c0 + 8 * nt + 2 * t + cc;
          if (c >= cl.ncols) continue;
          const int r = cl.dcw(c), q2 = c - r * cl.cw;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + 16 * mi + g + 8 * h;
              if (m >= sp.H) continue;
              const int k = sp.np * m + par;
              float vr = acc[mi][nt][0][2 * h + cc];
              float vi = acc[mi][nt][1][2 * h + cc];
              if (S == FIRST) {  // k = k1, column (r, nu2): twiddle, in place
                const float2 tw = __ldg(&twg[q2 * k]);
                const float a = vr;
                vr = fmaf(a, tw.x, -vi * tw.y);
                vi = fmaf(a, tw.y, vi * tw.x);
                const int o = r * cl.RS + k * P + q2;
                tl.sr[o] = vr;
                tl.si[o] = vi;
              } else {           // k = k2, column (r, k1): output order
                const int o = q2 + n1 * k;
                if (tl.direct) {
                  if (r < tl.rows) {
                    const size_t go = (size_t)(tl.row0 + r) * n + o;
                    yr[go] = vr;
                    yi[go] = vi;
                  }
                } else {
                  tl.sr[r * cl.RS + o] = vr;
                  tl.si[r * cl.RS + o] = vi;
                }
              }
            }
        }
    }
    __syncthreads();
  }
}

template <Stage S>
__device__ __forceinline__ void run_stage(const Tile& tl, const float2* w,
                                          const Spec& sp, int n1, int n2,
                                          int P,
                                          const float2* __restrict__ twg,
                                          float* yr, float* yi) {
  if (mm_mt(sp.H) == 2)
    stage<2, S>(tl, w, sp, n1, n2, P, twg, yr, yi);
  else
    stage<1, S>(tl, w, sp, n1, n2, P, twg, yr, yi);
}

// --------------------------------------------------------------------------
// fft_mm_kernel — TWO = false: fft_mm1 (n1 = 1); TWO = true: fft_mm2.
// w1g, w2g: the roots of n1 and n2; twg: the roots of n = n1 * n2.
// --------------------------------------------------------------------------
template <bool TWO>
__global__ void __launch_bounds__(MM_THREADS, 1)
fft_mm_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi, long long B,
              int n1, int n2, int R, int nb, const float2* __restrict__ w1g,
              const float2* __restrict__ w2g,
              const float2* __restrict__ twg) {
  extern __shared__ __align__(16) float smem[];
  const int n = n1 * n2;
  const int P = mm_pitch(n2);
  const int RS = n1 * P;
  const size_t plane = (size_t)R * RS;
  float2* w1 = reinterpret_cast<float2*>(smem + nb * 2 * plane);
  float2* w2 = w1 + n1;
  for (int q = threadIdx.x; q < n1; q += MM_THREADS)
    w1[q] = TWO ? w1g[q] : make_float2(1.0f, 0.0f);
  for (int q = threadIdx.x; q < n2; q += MM_THREADS) w2[q] = w2g[q];
  const bool vec =
      ((((uintptr_t)xr | (uintptr_t)xi | (uintptr_t)yr | (uintptr_t)yi) &
        15) == 0) &&
      n2 % 4 == 0;
  const long long tiles = (B + R - 1) / R;
  // the last stage stores from its accumulators when it takes rounds
  const bool direct = mm_units(n2, R * n1) > MM_WARPS;

  const Div by_n2(n2), by_n(n);
  auto load = [&](long long tile, int b) {
    const long long row0 = tile * R;
    const int rows = (int)(B - row0 < R ? B - row0 : R);
    const size_t g0 = (size_t)row0 * n;
    float* dr = smem + (size_t)b * 2 * plane;
    float* di = dr + plane;
    const int step = vec ? 4 : 1;
    for (int f = threadIdx.x * step; f < rows * n; f += MM_THREADS * step) {
      const int line = by_n2(f);   // r * n1 + nu1, and RS = n1 * P
      const int o = line * P + f - line * n2;
      if (vec) {
        cp_async16(dr + o, xr + g0 + f);
        cp_async16(di + o, xi + g0 + f);
      } else {
        cp_async4(dr + o, xr + g0 + f);
        cp_async4(di + o, xi + g0 + f);
      }
    }
  };

  long long tile = blockIdx.x;
  if (tile < tiles) load(tile, 0);
  cp_async_commit();
  int b = 0;
#pragma unroll 1
  for (; tile < tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (nb == 2) {
      if (next < tiles) load(next, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Tile tl;
    tl.sr = smem + (size_t)b * 2 * plane;
    tl.si = tl.sr + plane;
    tl.row0 = tile * R;
    tl.rows = (int)(B - tl.row0 < R ? B - tl.row0 : R);
    tl.direct = direct;
    if (TWO) {   // D_n1 over nu1: columns (r, nu2), rows nu1 at pitch P
      const Spec s1 = make_spec(n1, Cols{R * n2, n2, RS, 1, P, Div(n2)});
      run_stage<FIRST>(tl, w1, s1, n1, n2, P, twg, yr, yi);
    }
    // D_n2 over nu2: columns (r, k1), A[k1][.] contiguous at row k1 * P
    const Spec s2 = make_spec(n2, Cols{R * n1, n1, RS, P, 1, Div(n1)});
    run_stage<SECOND>(tl, w2, s2, n1, n2, P, twg, yr, yi);
    if (!direct) {   // the tile, in output order, leaves in 16-byte stores
      const size_t g0 = (size_t)tl.row0 * n;
      const float* sr = tl.sr;
      const float* si = tl.si;
      if (vec) {
        for (int f = threadIdx.x * 4; f < tl.rows * n; f += MM_THREADS * 4) {
          const int r = by_n(f);
          const int o = r * RS + f - r * n;
          *reinterpret_cast<float4*>(yr + g0 + f) =
              *reinterpret_cast<const float4*>(sr + o);
          *reinterpret_cast<float4*>(yi + g0 + f) =
              *reinterpret_cast<const float4*>(si + o);
        }
      } else {
        for (int f = threadIdx.x; f < tl.rows * n; f += MM_THREADS) {
          const int r = by_n(f);
          const int o = r * RS + f - r * n;
          yr[g0 + f] = sr[o];
          yi[g0 + f] = si[o];
        }
      }
      __syncthreads();
    }
    if (nb == 1 && next < tiles) {
      load(next, 0);
      cp_async_commit();
    }
    if (nb == 2) b ^= 1;
  }
  cp_async_wait<0>();
}

// Check the host's geometry and launch.
template <bool TWO>
cudaError_t launch_mm(const float* xr, const float* xi, float* yr, float* yi,
                      long long B, int n1, int n2, int R, int nb, int ctas,
                      int smem, const float2* w1, const float2* w2,
                      const float2* tw, cudaStream_t stream) {
  if (R < 1 || (nb != 1 && nb != 2) || ctas < 1 ||
      (size_t)smem != mm_smem(n1, n2, R, nb) || (size_t)smem > MM_SMEM_MAX ||
      (long long)R * n1 * n2 > (1LL << 30) || mm_group(n2) > MM_WARPS ||
      (TWO && mm_group(n1) > MM_WARPS))
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const void* k = (const void*)fft_mm_kernel<TWO>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fft_mm_kernel<TWO><<<ctas, MM_THREADS, smem, stream>>>(
      xr, xi, yr, yi, B, n1, n2, R, nb, w1, w2, tw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Direct DFT of (B, n) f32 rows, 1 <= n <= 128; `roots`: the n roots
// exp(sign*2*pi*i*e/n) as (re, im) pairs.  R rows a tile, nb buffers, ctas
// persistent CTAs and smem bytes as ops/pallas_fft.py:mm_geometry picks them.
int fft_mm1(const float* xr, const float* xi, float* yr, float* yi,
            long long B, int n, int R, int nb, int ctas, int smem,
            const float2* roots, void* stream) {
  if (n < 1 || n > MM_MAX_N) return cudaErrorInvalidValue;
  return launch_mm<false>(xr, xi, yr, yi, B, 1, n, R, nb, ctas, smem, roots,
                          roots, roots, (cudaStream_t)stream);
}

// Two-stage four-step of (B, n1 * n2) f32 rows, 2 <= n_i <= 128, output
// index k1 + n1 * k2; `tables`: the roots of n1, then of n2, then of
// n1 * n2, each exp(sign*2*pi*i*e/m) as (re, im) pairs.  Geometry as for
// fft_mm1.
int fft_mm2(const float* xr, const float* xi, float* yr, float* yi,
            long long B, int n1, int n2, int R, int nb, int ctas, int smem,
            const float2* tables, void* stream) {
  if (n1 < 2 || n1 > MM_MAX_N || n2 < 2 || n2 > MM_MAX_N)
    return cudaErrorInvalidValue;
  return launch_mm<true>(xr, xi, yr, yi, B, n1, n2, R, nb, ctas, smem,
                         tables, tables + n1, tables + n1 + n2,
                         (cudaStream_t)stream);
}

}  // extern "C"
