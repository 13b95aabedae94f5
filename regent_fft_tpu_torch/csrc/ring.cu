// The slab-ring FFT kernel for Hopper (sm_90a) on split re/im planes: f32
// (complex64) or bf16 (complex32):
//
//   fft_axis_ring_kernel<false, T>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_axis0_dma
//   fft_axis_ring_kernel<true, T>   the same kernel's fuse_last mode (fft_axes2_ring)
//
// Mode axis: the FFT along the middle axis n of (pre, n, post) planes.
// Mode fuse_last: the FFT along both trailing axes of (pre, n1, n2) planes.
// The norm scale is fused into the last write.
//
// Bound on H100: bytes.  The axis mode reads and writes each complex element
// once (16 B in f32, 8 B in bf16).  The fuse_last mode would too if a plane
// stayed on chip, but a 512 x 512 plane (2 MiB) is more than the 227 KB of
// shared memory a block can use, so, as fft_fused2_kernel does, the block
// owns its plane and makes two passes over it: column strips from the input
// into the output (bf16: into f32 scratch, below), then row strips from there
// into the output (up to twice the bytes once the 50 MB L2 no longer holds
// the planes in flight).  Flops
// (~5*log2(n) per element) are far below the FP32 ridge.
//
// Design.  The TPU kernel hides device-memory latency behind a K-deep ring of
// slab DMAs, because Mosaic's grid pipeline is only two deep.  Here one
// persistent block per SM walks its slabs (i += gridDim.x) through a
// RING_K = 2 deep ring of shared-memory buffers filled with cp.async: while
// the butterflies run on slab s, the load of slab s+1 is in flight
// (commit_group / wait_group 1).  Results go straight from shared memory to
// device memory (stores need no ring).  A column slab is fft_cols' (n, nt)
// tile (cols_geo): 64 KiB of f32 for every power of two n >= 16, so the f32
// ring takes 128 KiB of the 227 KB budget; the TPU's 512-lane slabs and its
// tunable depth are VMEM rules and are not copied.  f32 column slabs move in
// 16-byte cp.async.cg copies (post % 4 == 0, columns past `post`
// zero-filled).  The row strips of fuse_last land in the row tile, whose
// one-word pad every 32 words keeps the butterflies free of bank conflicts
// but breaks 16-byte alignment, so f32 strips move in 4-byte cp.async
// copies.
//
// bf16 planes (C entries fft_axis_ring_bf16, fft_axes2_ring_bf16: the TPU
// runner with io="bf16", whose tile bodies the plain versions keep).
// cp.async moves raw bytes: it cannot widen bf16 to f32, and a 4-byte copy
// cannot carry one 2-byte element into a padded f32 tile.  So the ring
// buffers hold the raw bf16 slab or strip, unpadded, filled in 16-byte
// copies (8-byte ones for the 4-column slabs of n = 2048; post % 8 == 0 and
// 16-byte aligned planes), and work() first widens its buffer into one f32
// tile past the ring (the column tile, or the padded row tile), then runs
// the f32 butterflies and rounds the scaled result to bf16 on the store.
// Shared memory in the axis mode: two 32 KiB bf16 buffers and a 64 KiB f32
// tile, against the f32 ring's 128 KiB.  The fuse_last mode keeps the plane between its
// column and row passes in f32, as the TPU kernel does in VMEM: each
// resident block owns one f32 scratch plane pair (the wrapper allocates one
// per block of the persistent grid, 264 MiB at 512 x 512 planes on 132 SMs,
// against 1 GiB for a whole-tensor scratch at 512^3), the column pass writes
// it, and the row pass reads it back as raw f32 strips in 16-byte copies and
// widens them into the padded tile, so its ring buffers are sized for f32
// strips (two 64 KiB buffers and the 66 KiB tile: 194 KiB, still one block
// an SM).  That moves 24 B per element instead of a bf16 intermediate's 16.
// TMA and mbarrier pipelines are later work.

#include <type_traits>

#include "stockham_tile.cuh"

namespace {

constexpr size_t RING_SMEM_MAX = 232448;   // 227 KB, the per-block limit
constexpr int RING_K = 2;                  // ring depth (buffers per block)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Global -> shared copies of 16 bytes through L2 only (.cg), or of 8 or 4
// bytes through L1; `bytes` below the copy size zero-fills the rest of the
// destination (0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Run `count` items through a K-deep ring: load(i, b) issues item i's copies
// into buffer b; work(i, b) transforms buffer b and writes it out.  One
// commit group per item (empty past the end), so wait_group K-1 always
// means "item i has landed".
template <class Load, class Work>
__device__ __forceinline__ void ring(int count, Load&& load, Work&& work) {
  constexpr int K = RING_K;
#pragma unroll 1
  for (int i = 0; i < K - 1; ++i) {
    if (i < count) load(i, i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    const int nx = i + K - 1;
    if (nx < count) load(nx, nx % K);
    cp_async_commit();
    cp_async_wait<K - 1>();
    __syncthreads();
    work(i, i % K);
    __syncthreads();
  }
}

// Column slab: rows [0, n) at row stride ld from `base`, columns
// [c0, c0 + nt), into buf as the column tile (element (t, j) at j * nt + t;
// re plane, then im plane).  Columns at or past `ncols` are zero-filled.
__device__ void load_cols(const float* xr, const float* xi, float* buf,
                          size_t base, long long ld, int c0, int ncols, int n,
                          int nt) {
  const int q4 = nt >> 2;   // 16-byte chunks per slab row
  const int per = n * q4;
  for (int q = threadIdx.x; q < 2 * per; q += THREADS) {
    const int im = q >= per;
    const int r = q - im * per;
    const int j = r / q4;
    const int c = (r - j * q4) << 2;
    const bool ok = c0 + c < ncols;
    const float* src = im ? xi : xr;
    cp_async16(buf + (size_t)im * n * nt + j * nt + c,
               ok ? src + base + (size_t)j * ld + c0 + c : src, ok ? 16 : 0);
  }
}

// Transform the column tile in buf along n and write it, scaled, to the
// same place in y.
template <typename T>
__device__ void work_cols(float* buf, T* yr, T* yi, size_t base, long long ld,
                          int c0, int ncols, const StagePlan& p,
                          const float2* __restrict__ tw, float s, float scale) {
  const Geo g = cols_geo(p.n);
  float* sr = buf;
  float* si = sr + p.n * g.nt;
  const int t = threadIdx.x & (g.nt - 1);
  const int jl = threadIdx.x >> g.lnt;
  fft_tile<false>(sr, si, p, tw, s, t, jl, g);
  if (c0 + t < ncols) {
    for (int j = jl; j < p.n; j += g.tj) {
      const int a = at<false>(t, j, g);
      const size_t o = base + (size_t)j * ld + c0 + t;
      yr[o] = from_f32<T>(sr[a] * scale);
      yi[o] = from_f32<T>(si[a] * scale);
    }
  }
}

// Row strip: rows [r0, r0 + nt) of an (nrows, n) plane at `base` into buf as
// the row tile.  Rows at or past `nrows` are zero-filled.
__device__ void load_rows(const float* yr, const float* yi, float* buf,
                          size_t base, int r0, int nrows, int n, const Geo& g) {
  const int per = g.nt * n;
  for (int q = threadIdx.x; q < 2 * per; q += THREADS) {
    const int im = q >= per;
    const int r = q - im * per;
    const int t = r / n;
    const int j = r - t * n;
    const bool ok = r0 + t < nrows;
    const float* src = im ? yi : yr;
    cp_async4(buf + (size_t)im * g.nt * g.pitch + at<true>(t, j, g),
              ok ? src + base + (size_t)(r0 + t) * n + j : src, ok ? 4 : 0);
  }
}

// Transform the row tile in buf along n and write it, scaled, back in place.
template <typename T>
__device__ void work_rows(float* buf, T* yr, T* yi, size_t base, int r0,
                          int nrows, const StagePlan& p,
                          const float2* __restrict__ tw, float s, float scale) {
  const Geo g = rows_geo(p.n);
  float* sr = buf;
  float* si = sr + g.nt * g.pitch;
  const int t = threadIdx.x >> ilog2(g.tj);
  const int jl = threadIdx.x & (g.tj - 1);
  fft_tile<true>(sr, si, p, tw, s, t, jl, g);
  if (r0 + t < nrows) {
    for (int j = jl; j < p.n; j += g.tj) {
      const int a = at<true>(t, j, g);
      const size_t o = base + (size_t)(r0 + t) * p.n + j;
      yr[o] = from_f32<T>(sr[a] * scale);
      yi[o] = from_f32<T>(si[a] * scale);
    }
  }
}

// bf16 column slab: as load_cols, into buf unpadded (element (t, j) at
// j * nt + t, re plane then im plane) in copies of min(8, nt) elements (16
// bytes, or 8 for nt = 4).  Columns at or past `ncols` are zero-filled.
__device__ void load_cols(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                          __nv_bfloat16* buf, size_t base, long long ld,
                          int c0, int ncols, int n, int nt) {
  const int ch = nt < 8 ? nt : 8;   // elements per copy
  const int qn = nt / ch;           // copies per slab row
  const int per = n * qn;
  for (int q = threadIdx.x; q < 2 * per; q += THREADS) {
    const int im = q >= per;
    const int r = q - im * per;
    const int j = r / qn;
    const int c = (r - j * qn) * ch;
    const bool ok = c0 + c < ncols;
    const __nv_bfloat16* src = im ? xi : xr;
    __nv_bfloat16* dst = buf + (size_t)im * n * nt + j * nt + c;
    const __nv_bfloat16* from = ok ? src + base + (size_t)j * ld + c0 + c : src;
    if (ch == 8)
      cp_async16(dst, from, ok ? 16 : 0);
    else
      cp_async8(dst, from, ok ? 8 : 0);
  }
}

// Raw row strip: rows [r0, r0 + nt) of an (nrows, n) plane at `base` into
// buf unpadded (element (t, j) at t * n + j) in 16-byte copies (n a multiple
// of 16 / sizeof(S): 8 bf16 or 4 f32).  Rows at or past `nrows` are
// zero-filled.
template <typename S>
__device__ void load_rows_raw(const S* yr, const S* yi, S* buf, size_t base,
                              int r0, int nrows, int n, const Geo& g) {
  constexpr int ch = 16 / sizeof(S);   // elements per copy
  const int qn = n / ch;
  const int per = g.nt * qn;
  for (int q = threadIdx.x; q < 2 * per; q += THREADS) {
    const int im = q >= per;
    const int r = q - im * per;
    const int t = r / qn;
    const int j = (r - t * qn) * ch;
    const bool ok = r0 + t < nrows;
    const S* src = im ? yi : yr;
    cp_async16(buf + (size_t)im * g.nt * n + t * n + j,
               ok ? src + base + (size_t)(r0 + t) * n + j : src, ok ? 16 : 0);
  }
}

// Widen a raw bf16 column slab into the f32 column tile (the same layout).
__device__ void widen_cols(const __nv_bfloat16* buf, float* tile, int n,
                           int nt) {
  for (int q = threadIdx.x; q < 2 * n * nt; q += THREADS)
    tile[q] = __bfloat162float(buf[q]);
}

// Widen a raw (bf16 or f32) row strip into the padded f32 row tile.
template <typename S>
__device__ void widen_rows(const S* buf, float* tile, int n, const Geo& g) {
  const int per = g.nt * n;
  for (int q = threadIdx.x; q < 2 * per; q += THREADS) {
    const int im = q >= per;
    const int r = q - im * per;
    const int t = r / n;
    tile[(size_t)im * g.nt * g.pitch + at<true>(t, r - t * n, g)] =
        to_f32(buf[q]);
  }
}

// --------------------------------------------------------------------------
// fft_axis_ring_kernel — see the note at the top.  `bstride` is the size of
// one ring buffer in elements of T.  FUSE: p1 is the n1-point (column)
// transform, p2 the n2-point (row) transform, post == n2, and mr, mi the f32
// planes between the passes: the output planes for f32 data, one
// (n1, n2) scratch plane pair per block for bf16 (block b's at b * n1 * n2).
// For bf16 planes (WIDEN) the f32 tile work() transforms lies past the ring.
// --------------------------------------------------------------------------
template <bool FUSE, typename T>
__global__ void __launch_bounds__(THREADS, 1)
fft_axis_ring_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     T* yr, T* yi, float* mr, float* mi, long long pre,
                     int post, int bstride, StagePlan p1,
                     const float2* __restrict__ tw1, StagePlan p2,
                     const float2* __restrict__ tw2, float s, float scale) {
  constexpr bool WIDEN = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  T* const ring0 = reinterpret_cast<T*>(smem);
  float* const wide = reinterpret_cast<float*>(ring0 + RING_K * bstride);
  const int n = p1.n;
  const int nt = cols_geo(n).nt;
  const int ncb = (post + nt - 1) / nt;
  auto buf = [&](int b) { return ring0 + (size_t)b * bstride; };
  // The f32 tile of buffer b, column layout (widened first for bf16).
  auto cols_tile = [&](int b) -> float* {
    if constexpr (WIDEN) {
      widen_cols(buf(b), wide, n, nt);
      __syncthreads();
      return wide;
    } else {
      return buf(b);
    }
  };
  if constexpr (!FUSE) {
    const long long total = pre * ncb;
    const long long first = blockIdx.x;
    const int count =
        first < total ? (int)((total - 1 - first) / gridDim.x + 1) : 0;
    auto slab = [&](int i, size_t& base, int& c0) {
      const long long id = first + (long long)i * gridDim.x;
      const long long pl = id / ncb;
      c0 = (int)(id - pl * ncb) * nt;
      base = (size_t)pl * n * post;
    };
    ring(
        count,
        [&](int i, int b) {
          size_t base;
          int c0;
          slab(i, base, c0);
          load_cols(xr, xi, buf(b), base, post, c0, post, n, nt);
        },
        [&](int i, int b) {
          size_t base;
          int c0;
          slab(i, base, c0);
          work_cols(cols_tile(b), yr, yi, base, post, c0, post, p1, tw1, s,
                    scale);
        });
  } else {
    const Geo g2 = rows_geo(p2.n);
    const int nrs = (n + g2.nt - 1) / g2.nt;
    // the raw f32 strip in buffer b (bf16 planes), widened into the tile
    auto fbuf = [&](int b) { return reinterpret_cast<float*>(buf(b)); };
    auto rows_tile = [&](int b) -> float* {
      if constexpr (WIDEN) {
        widen_rows(fbuf(b), wide, post, g2);
        __syncthreads();
        return wide;
      } else {
        return buf(b);
      }
    };
    const size_t mine = (size_t)blockIdx.x * n * post;   // bf16: own scratch
#pragma unroll 1
    for (long long pl = blockIdx.x; pl < pre; pl += gridDim.x) {
      const size_t base = (size_t)pl * n * post;
      const size_t mbase = WIDEN ? mine : base;
      // columns: input -> the f32 planes m, unscaled
      ring(
          ncb,
          [&](int i, int b) {
            load_cols(xr, xi, buf(b), base, post, i * nt, post, n, nt);
          },
          [&](int i, int b) {
            work_cols(cols_tile(b), mr, mi, mbase, post, i * nt, post, p1,
                      tw1, s, 1.0f);
          });
      // The ring ended on __syncthreads(): this block's writes to the plane
      // are visible to all of its threads.  Rows: m -> output.
      ring(
          nrs,
          [&](int i, int b) {
            if constexpr (WIDEN)
              load_rows_raw(mr, mi, fbuf(b), mbase, i * g2.nt, n, post, g2);
            else
              load_rows(mr, mi, buf(b), mbase, i * g2.nt, n, post, g2);
          },
          [&](int i, int b) {
            work_rows(rows_tile(b), yr, yi, base, i * g2.nt, n, p2, tw2, s,
                      scale);
          });
    }
  }
}

// `tile_bytes`: the f32 tile past the ring (0 for f32 planes).
// `mr`, `mi`: FUSE's f32 planes between the passes; for bf16 data `nscr`
// scratch plane pairs, and the grid takes at most that many blocks.
template <bool FUSE, typename T>
cudaError_t launch_ring(const T* xr, const T* xi, T* yr, T* yi, float* mr,
                        float* mi, long long nscr, long long pre, int post,
                        int bstride, size_t tile_bytes, long long items,
                        const StagePlan& p1,
                        const float2* tw1, const StagePlan& p2,
                        const float2* tw2, float s, float scale,
                        cudaStream_t stream) {
  const size_t smem = (size_t)RING_K * bstride * sizeof(T) + tile_bytes;
  if (smem > RING_SMEM_MAX) return cudaErrorInvalidValue;
  const void* kern = (const void*)fft_axis_ring_kernel<FUSE, T>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = (long long)sms * per_sm;
  if (grid > items) grid = items;
  if (grid > nscr) grid = nscr;
  fft_axis_ring_kernel<FUSE, T><<<(unsigned)grid, THREADS, smem, stream>>>(
      xr, xi, yr, yi, mr, mi, pre, post, bstride, p1, tw1, p2, tw2, s, scale);
  return cudaGetLastError();
}

// v rounded up to whole 16-byte chunks of T.
template <typename T>
int round16(long long v) {
  constexpr long long k = 16 / sizeof(T);
  return (int)((v + k - 1) / k * k);
}

template <typename T>
int axis_ring(const T* xr, const T* xi, T* yr, T* yi, long long pre, int n,
              int post, int sign, float scale, const float2* tw, int nstages,
              const int* radices, void* stream) {
  constexpr bool WIDEN = !std::is_same<T, float>::value;
  StagePlan p;
  if (make_plan(n, nstages, radices, &p)) return cudaErrorInvalidValue;
  const int nt = cols_geo(n).nt;
  if (post < 1 || post % (16 / sizeof(T)) || nt < 4)
    return cudaErrorInvalidValue;
  if (pre <= 0) return cudaSuccess;
  const long long tile = 2LL * n * nt;
  const long long items = pre * ((post + nt - 1) / nt);
  return launch_ring<false>(xr, xi, yr, yi, nullptr, nullptr, items, pre,
                            post, round16<T>(tile),
                            WIDEN ? tile * sizeof(float) : 0, items, p, tw, p,
                            tw, (float)sign, scale, (cudaStream_t)stream);
}

// `mr`, `mi`: the f32 planes between the passes (the output planes for f32
// data, `nscr` scratch plane pairs for bf16).
template <typename T>
int axes2_ring(const T* xr, const T* xi, T* yr, T* yi, float* mr, float* mi,
               long long nscr, long long pre, int n1, int n2, int sign,
               float scale, const float2* tw1, int nstages1,
               const int* radices1, const float2* tw2, int nstages2,
               const int* radices2, void* stream) {
  constexpr bool WIDEN = !std::is_same<T, float>::value;
  StagePlan p1, p2;
  if (make_plan(n1, nstages1, radices1, &p1)) return cudaErrorInvalidValue;
  if (make_plan(n2, nstages2, radices2, &p2)) return cudaErrorInvalidValue;
  if (n2 % (16 / sizeof(T)) || cols_geo(n1).nt < 4 || nscr < 1)
    return cudaErrorInvalidValue;
  if (pre <= 0) return cudaSuccess;
  const Geo g2 = rows_geo(n2);
  const long long a = 2LL * n1 * cols_geo(n1).nt;
  const long long b = 2LL * g2.nt * g2.pitch;   // the padded f32 row tile
  const long long tile = a > b ? a : b;
  // bf16 buffers hold the raw (unpadded) f32 row strip of the scratch plane,
  // in elements of T; f32 ones the tile
  const long long raw =
      WIDEN ? 2LL * g2.nt * n2 * (long long)(sizeof(float) / sizeof(T)) : b;
  return launch_ring<true>(xr, xi, yr, yi, mr, mi, nscr, pre, n2,
                           round16<T>(a > raw ? a : raw),
                           WIDEN ? tile * sizeof(float) : 0, pre, p1, tw1, p2,
                           tw2, (float)sign, scale, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// FFT along the middle axis of (pre, n, post) f32 planes through the slab
// ring; post % 4 == 0 and 16-byte aligned planes.
int fft_axis_ring(const float* xr, const float* xi, float* yr, float* yi,
                  long long pre, int n, int post, int sign, float scale,
                  const float2* tw, int nstages, const int* radices,
                  void* stream) {
  return axis_ring(xr, xi, yr, yi, pre, n, post, sign, scale, tw, nstages,
                   radices, stream);
}

// The same on bf16 planes (f32 compute); post % 8 == 0.
int fft_axis_ring_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                       __nv_bfloat16* yr, __nv_bfloat16* yi, long long pre,
                       int n, int post, int sign, float scale,
                       const float2* tw, int nstages, const int* radices,
                       void* stream) {
  return axis_ring(xr, xi, yr, yi, pre, n, post, sign, scale, tw, nstages,
                   radices, stream);
}

// FFT along both trailing axes of (pre, n1, n2) f32 planes through the slab
// ring; n2 % 4 == 0 and 16-byte aligned planes.
int fft_axes2_ring(const float* xr, const float* xi, float* yr, float* yi,
                   long long pre, int n1, int n2, int sign, float scale,
                   const float2* tw1, int nstages1, const int* radices1,
                   const float2* tw2, int nstages2, const int* radices2,
                   void* stream) {
  return axes2_ring(xr, xi, yr, yi, yr, yi, pre, pre, n1, n2, sign, scale,
                    tw1, nstages1, radices1, tw2, nstages2, radices2, stream);
}

// The same on bf16 planes (f32 compute); n2 % 8 == 0.  The intermediate
// between the column and row passes stays f32 in `nscr` >= 1 scratch plane
// pairs of n1 * n2 floats (16-byte aligned); the grid takes at most nscr
// blocks.
int fft_axes2_ring_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, float* mr,
                        float* mi, long long nscr, long long pre, int n1,
                        int n2, int sign, float scale, const float2* tw1,
                        int nstages1, const int* radices1, const float2* tw2,
                        int nstages2, const int* radices2, void* stream) {
  return axes2_ring(xr, xi, yr, yi, mr, mi, nscr, pre, n1, n2, sign, scale,
                    tw1, nstages1, radices1, tw2, nstages2, radices2, stream);
}

}  // extern "C"
