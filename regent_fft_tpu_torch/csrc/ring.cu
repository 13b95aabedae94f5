// The slab-ring FFT kernel for Hopper (sm_90a), complex64 as split f32 re/im
// planes:
//
//   fft_axis_ring_kernel<false>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_axis0_dma
//   fft_axis_ring_kernel<true>   the same kernel's fuse_last mode (fft_axes2_ring)
//
// Mode axis: the FFT along the middle axis n of (pre, n, post) planes.
// Mode fuse_last: the FFT along both trailing axes of (pre, n1, n2) planes.
// The norm scale is fused into the last write.
//
// Bound on H100: bytes.  The axis mode reads and writes each complex element
// once (16 B).  The fuse_last mode would too if a plane stayed on chip, but a
// 512 x 512 plane (2 MiB) is more than the 227 KB of shared memory a block
// can use, so, as fft_fused2_kernel does, the block owns its plane and makes
// two passes over it: column strips from the input into the output, then row
// strips of the output in place (up to 32 B per element once the 50 MB L2 no
// longer holds the planes in flight).  Flops (~5*log2(n) per element) are far
// below the FP32 ridge.
//
// Design.  The TPU kernel hides device-memory latency behind a K-deep ring of
// slab DMAs, because Mosaic's grid pipeline is only two deep.  Here one
// persistent block per SM walks its slabs (i += gridDim.x) through a
// RING_K = 2 deep ring of shared-memory buffers filled with cp.async: while
// the butterflies run on slab s, the load of slab s+1 is in flight
// (commit_group / wait_group 1).  Results go straight from shared memory to
// device memory (stores need no ring).  A column slab is fft_cols' (n, nt)
// tile (cols_geo): 64 KiB for every power of two n >= 16, so the ring takes
// 128 KiB of the 227 KB budget; the TPU's 512-lane slabs and its tunable
// depth are VMEM rules and are not copied.  Column slabs move in 16-byte
// cp.async.cg copies (post % 4 == 0, columns past `post` zero-filled).  The
// row strips of fuse_last land in the row tile, whose one-word pad every 32
// words keeps the butterflies free of bank conflicts but breaks 16-byte
// alignment, so they move in 4-byte cp.async copies.  TMA and mbarrier
// pipelines are later work.

#include "stockham_tile.cuh"

namespace {

constexpr size_t RING_SMEM_MAX = 232448;   // 227 KB, the per-block limit
constexpr int RING_K = 2;                  // ring depth (buffers per block)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy through L2 only; `bytes` < 16 zero-fills
// the rest of the destination (0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

// Transform the column slab in buf along n and write it, scaled, to the
// same place in y.
__device__ void work_cols(float* buf, float* yr, float* yi, size_t base,
                          long long ld, int c0, int ncols, const StagePlan& p,
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
      yr[o] = sr[a] * scale;
      yi[o] = si[a] * scale;
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

// Transform the row strip in buf along n and write it, scaled, back in place.
__device__ void work_rows(float* buf, float* yr, float* yi, size_t base,
                          int r0, int nrows, const StagePlan& p,
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
      yr[o] = sr[a] * scale;
      yi[o] = si[a] * scale;
    }
  }
}

// --------------------------------------------------------------------------
// fft_axis_ring_kernel — see the note at the top.  `bstride` is the size of
// one ring buffer in floats.  FUSE: p1 is the n1-point (column) transform,
// p2 the n2-point (row) transform, post == n2.
// --------------------------------------------------------------------------
template <bool FUSE>
__global__ void __launch_bounds__(THREADS, 1)
fft_axis_ring_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* yr, float* yi, long long pre, int post,
                     int bstride, StagePlan p1, const float2* __restrict__ tw1,
                     StagePlan p2, const float2* __restrict__ tw2, float s,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = p1.n;
  const int nt = cols_geo(n).nt;
  const int ncb = (post + nt - 1) / nt;
  auto buf = [&](int b) { return smem + (size_t)b * bstride; };
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
          work_cols(buf(b), yr, yi, base, post, c0, post, p1, tw1, s, scale);
        });
  } else {
    const Geo g2 = rows_geo(p2.n);
    const int nrs = (n + g2.nt - 1) / g2.nt;
#pragma unroll 1
    for (long long pl = blockIdx.x; pl < pre; pl += gridDim.x) {
      const size_t base = (size_t)pl * n * post;
      // columns: input -> output, unscaled
      ring(
          ncb,
          [&](int i, int b) {
            load_cols(xr, xi, buf(b), base, post, i * nt, post, n, nt);
          },
          [&](int i, int b) {
            work_cols(buf(b), yr, yi, base, post, i * nt, post, p1, tw1, s,
                      1.0f);
          });
      // The ring ended on __syncthreads(): this block's writes to the plane
      // are visible to all of its threads.  Rows of the output, in place.
      ring(
          nrs,
          [&](int i, int b) {
            load_rows(yr, yi, buf(b), base, i * g2.nt, n, post, g2);
          },
          [&](int i, int b) {
            work_rows(buf(b), yr, yi, base, i * g2.nt, n, p2, tw2, s, scale);
          });
    }
  }
}

template <bool FUSE>
cudaError_t launch_ring(const float* xr, const float* xi, float* yr, float* yi,
                        long long pre, int post, int bstride, long long items,
                        const StagePlan& p1, const float2* tw1,
                        const StagePlan& p2, const float2* tw2, float s,
                        float scale, cudaStream_t stream) {
  const size_t smem = (size_t)RING_K * bstride * sizeof(float);
  if (smem > RING_SMEM_MAX) return cudaErrorInvalidValue;
  const void* kern = (const void*)fft_axis_ring_kernel<FUSE>;
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
  fft_axis_ring_kernel<FUSE><<<(unsigned)grid, THREADS, smem, stream>>>(
      xr, xi, yr, yi, pre, post, bstride, p1, tw1, p2, tw2, s, scale);
  return cudaGetLastError();
}

int round4(long long v) { return (int)((v + 3) & ~3LL); }

}  // namespace

extern "C" {

// FFT along the middle axis of (pre, n, post) f32 planes through the slab
// ring; post % 4 == 0 and 16-byte aligned planes.
int fft_axis_ring(const float* xr, const float* xi, float* yr, float* yi,
                  long long pre, int n, int post, int sign, float scale,
                  const float2* tw, int nstages, const int* radices,
                  void* stream) {
  StagePlan p;
  if (make_plan(n, nstages, radices, &p)) return cudaErrorInvalidValue;
  const int nt = cols_geo(n).nt;
  if (post < 1 || post % 4 || nt < 4) return cudaErrorInvalidValue;
  if (pre <= 0) return cudaSuccess;
  const int bstride = round4(2LL * n * nt);
  const long long items = pre * ((post + nt - 1) / nt);
  return launch_ring<false>(xr, xi, yr, yi, pre, post, bstride, items, p, tw,
                            p, tw, (float)sign, scale, (cudaStream_t)stream);
}

// FFT along both trailing axes of (pre, n1, n2) f32 planes through the slab
// ring; n2 % 4 == 0 and 16-byte aligned planes.
int fft_axes2_ring(const float* xr, const float* xi, float* yr, float* yi,
                   long long pre, int n1, int n2, int sign, float scale,
                   const float2* tw1, int nstages1, const int* radices1,
                   const float2* tw2, int nstages2, const int* radices2,
                   void* stream) {
  StagePlan p1, p2;
  if (make_plan(n1, nstages1, radices1, &p1)) return cudaErrorInvalidValue;
  if (make_plan(n2, nstages2, radices2, &p2)) return cudaErrorInvalidValue;
  if (n2 % 4 || cols_geo(n1).nt < 4) return cudaErrorInvalidValue;
  if (pre <= 0) return cudaSuccess;
  const Geo g2 = rows_geo(n2);
  const long long a = 2LL * n1 * cols_geo(n1).nt, b = 2LL * g2.nt * g2.pitch;
  const int bstride = round4(a > b ? a : b);
  return launch_ring<true>(xr, xi, yr, yi, pre, n2, bstride, pre, p1, tw1, p2,
                           tw2, (float)sign, scale, (cudaStream_t)stream);
}

}  // extern "C"
