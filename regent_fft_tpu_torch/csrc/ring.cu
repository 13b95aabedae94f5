// The slab-ring FFT kernels for Hopper (sm_90a) on split re/im planes, f32
// (complex64) or bf16 (complex32):
//
//   fft_axis_ring_kernel<T,G,R...>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_axis0_dma
//                                   (C entries fft_axis_ring, fft_axis_ring_bf16)
//   fft_axes2_ring_kernel<T,S>      the same TPU kernel's fuse_last mode
//                                   (C entries fft_axes2_ring, fft_axes2_ring_bf16)
//
// Axis mode: the FFT along the middle axis n of (pre, n, post) planes.
// fuse_last mode: the FFT along both trailing axes of (pre, n1, n2) planes.
// f32 arithmetic on either plane type; the norm scale rides the last write,
// and bf16 output is rounded to nearest even once, after the scale.
//
// Bound on H100: bytes.  Each complex element is read once and written once
// (16 B in f32, 8 B in bf16: 0.641 / 0.3205 ms for 2^27 elements at
// 3.35 TB/s); ~5*log2(n) flops an element is far below the FP32 ridge.
//
// What the TPU kernel does, and what is kept.  _runner_axis0_dma keeps K
// slab copies in flight with manual DMAs because Mosaic's grid pipeline is
// only two deep, and in fuse_last mode it holds a whole plane in VMEM, so
// each element crosses HBM once each way.  Here the bulk-copy engine (TMA)
// takes the place of the DMAs: one elected thread issues 2-D tensor-map
// copies (cp.async.bulk.tensor, boxes of at most 256 rows, maps made on the
// host with cuTensorMapEncodeTiled through cudaGetDriverEntryPoint), each
// slab's copies complete the transaction of its own mbarrier, and the
// threads spend no instructions or registers on loads.
//
// Axis mode (fft_axis_ring_kernel): fft_cols' register-resident column body
// (cols.cuh: a column of n points held by n/E threads of E values each)
// fed by a K-deep ring.  A persistent block (grid: the SMs times the
// resident blocks an SM, at most the item count) walks its items (plane,
// tile of C columns), i += gridDim.x.  Item i lands in slab i % K: its
// (n, C) re and im tiles, element x of column c at x*C + c, n/BR boxes of
// BR rows each (BR the largest divisor of n up to 256), the columns past
// `post` zero-filled by the map.  Stage 0 reads the slab into registers;
// every thread then arrives on the slab's `empty` mbarrier, and after
// stage 0 thread 0 waits for it and issues item i + K into the same slab,
// so the next K items are in flight while this one's stages and stores
// run.  The later stages exchange through one f32 buffer past the ring,
// with a block barrier before each exchange's writes; the last stage
// stores straight to device memory with the scale.  A bf16 slab is half
// an f32 one (the exchange is f32 either way).  Tile width and depth per
// length and type (RingGeo, mirrored by ops/stockham_kernels.py:
// ring_geometry): E the first radix (16 from n = 16 on: one radix-16
// butterfly a thread), the widest power-of-two tile up to 256 columns and
// 512 threads whose ring is at least 2 deep beside the exchange buffer in
// 227 KB, K at most 4, rows of at least 16 bytes (the TMA's least inner
// box).  At n = 512 that is 16 columns and 512 threads, K = 2 in f32 (64
// KiB slabs) and K = 4 in bf16.  bf16 at n = 1536 and 2048 needs 8 columns
// (16-byte rows) and so E = 32 to stay within 512 threads; at 2048 the f32
// exchange of 8 columns (128 KiB) leaves room for one slab: K = 1, so the
// next item's copy overlaps only this item's later stages and stores.
// What holds the mode below its bound at n = 512 in f32: a 2-deep ring
// beside the exchange fits only 16-column tiles, 64-byte rows, where
// fft_cols (no ring) reads 128-byte rows.
//
// fuse_last mode (fft_axes2_ring_kernel): fft_fused2's cluster body
// (fused2.cuh: one (n1, n2) plane per thread-block cluster of C CTAs, CTA c
// holding the stripe of columns [c*w, (c+1)*w), w = n2/C, the row pass
// gathering its rows through distributed shared memory), made persistent
// and fed by the TMA.  Cluster q walks planes q, q + Q, ... (Q the clusters
// the card holds at once, cudaOccupancyMaxActiveClusters, at most the plane
// count).  The stripe is cut into S sub-slabs of ws = w/S columns (S = 2;
// 1 where a half-stripe row is no TMA box row, under 16 bytes or not a
// multiple of them: bf16 with w = 8, 24, 40, 56; 4 where w/2 is over the
// box's 256 elements: w = 640..1024, the stripes of n1 = 16 planes),
// stored sub-slab by sub-slab (element (row j, column t) of sub-slab s at
// s*N + j*ws + t, N = n1*ws), each a column of TMA boxes (ws, BR) with its
// own mbarrier.  Each sub-slab lands where the column pass uses it, and the
// column butterflies of sub-slab s start as soon as its barrier completes,
// while the later sub-slabs are still arriving: an S-deep ring with no
// buffer of its own.  The next plane's copies go out as soon as their
// place is free: the sub-slabs of the stripe's lower half (below the rows)
// once the gather's second cluster barrier says every CTA has read its
// stripe, the others once the last row stage has read the rows into
// registers, before its stores to device memory drain.  A
// fence.proxy.async orders the threads' shared-memory writes before the
// copies that overwrite them.
// bf16 sub-slabs land raw in the upper half of their f32 place and are
// widened in place (each thread reads its 16-byte groups into registers,
// one block barrier, then writes them as f32), so the plane needs no
// scratch: each element crosses device memory once each way.  The row pass
// and its stores are fft_fused2's.  What holds the mode below its bound:
// the cluster's stages and gather, which the copies now overlap, take most
// of a plane's time, and at 512^2 the card holds 7 clusters of 16 CTAs, so
// 20 SMs idle.
//
// Conventions: launched on the caller's stream, never synchronises,
// allocates nothing; each C entry returns cudaGetLastError(), or a CUDA
// error for what it refuses (a length with no instance, a stage list that
// is not the instance's, a geometry the kernel does not take, no cluster
// that fits, a tensor map the driver will not encode).

#include <cooperative_groups.h>
#include <cuda.h>

#include <mutex>
#include <type_traits>

#include "stockham_tile.cuh"
#include "radix.cuh"
#include "cols.cuh"
#include "fused2.cuh"

namespace cg = cooperative_groups;

namespace {

// --------------------------------------------------------------------------
// Bulk copies and mbarriers
// --------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// The barriers' initialisation, visible to the bulk-copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This thread's earlier shared-memory accesses before later bulk copies
// (the generic proxy before the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of tensor map `map` at (column x, row y) into dst; its bytes
// complete the transaction of `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// Rows [y, y + nbox*brows) of columns [x, x + cols) of the re and im maps
// into dr and di (row-major tiles), completing the transaction of `bar`.
// One thread.
template <typename T>
__device__ __forceinline__ void load_tiles(T* dr, T* di, const CUtensorMap* mr,
                                           const CUtensorMap* mi, int x, int y,
                                           int nbox, int brows, int cols,
                                           uint64_t* bar) {
  const int box = brows * cols;
  mbar_expect_tx(bar, 2u * nbox * box * (unsigned)sizeof(T));
  for (int k = 0; k < nbox; ++k) {
    tma_load_2d(dr + k * box, mr, x, y + k * brows, bar);
    tma_load_2d(di + k * box, mi, x, y + k * brows, bar);
  }
}

// The dynamic shared memory from its first 128-byte boundary (the place of
// a TMA box must be 128-byte aligned; the launch asks for SMEM_ALIGN more).
constexpr int SMEM_ALIGN = 128;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return p + ((SMEM_ALIGN - (smem_addr(p) & (SMEM_ALIGN - 1)))
              & (SMEM_ALIGN - 1));
}

// The largest divisor of n up to 256: the rows of a TMA box.
__host__ __device__ constexpr int box_rows(int n) {
  int b = n < 256 ? n : 256;
  while (n % b) --b;
  return b;
}

__host__ __device__ constexpr size_t round128(size_t v) {
  return (v + 127) / 128 * 128;
}

// The host's tensor maps: cuTensorMapEncodeTiled, reached through the
// runtime (no link against the driver library).
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) == cudaSuccess
        && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The 2-D map of a row-major (rows, cols) plane of T at `base`, boxes of
// (bcols, brows); reads past the last column are zero-filled.  L2 fetches
// are promoted to 128 bytes, so a 16-column f32 tile's 64-byte rows bring
// the neighbouring tile's half of each line along.
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const T* base, long long rows,
                       long long cols, int bcols, int brows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)bcols, (cuuint32_t)brows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(base), dim, stride, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --------------------------------------------------------------------------
// Axis mode
// --------------------------------------------------------------------------
constexpr int RING_MAX_K = 4;
// the dynamic shared memory a ring may take beside its barriers and the
// alignment slack
constexpr size_t RING_SMEM = COLS_SMEM_MAX - 128 - SMEM_ALIGN;

__host__ __device__ constexpr int ring_depth(int n, int c, int s, int es) {
  const size_t raw = round128((size_t)2 * es * n * c);
  const size_t xch = s >= 2 ? (size_t)8 * n * c : 0;
  const size_t k = xch < RING_SMEM ? (RING_SMEM - xch) / raw : 0;
  return k < RING_MAX_K ? (int)k : RING_MAX_K;
}

// Values a thread: the list's first radix R0 (one butterfly a thread in
// the radix-16 stages), or 2*R0 where a tile of the narrowest width (16-byte
// rows) would need more than 512 threads (bf16 at n = 2048).
__host__ __device__ constexpr int ring_values(int n, int r0, int es) {
  return (n / r0) * (16 / es) <= 512 ? r0 : 2 * r0;
}

// Columns a tile: the widest power of two up to 256 columns and 512
// threads (n/E a column) whose ring is at least 2 deep, else the narrowest
// with 16-byte rows.
__host__ __device__ constexpr int ring_cols(int n, int e, int s, int es) {
  int c = 256;
  while (c > 1 && (n / e) * c > 512) c /= 2;
  const int cmin = 16 / es;
  for (; c > cmin; c /= 2)
    if (ring_depth(n, c, s, es) >= 2) return c;
  return cmin;
}

template <typename T, int N_, int E, int S>
struct RingGeo : ColsGeo<N_, E, ring_cols(N_, E, S, sizeof(T)), S> {
  using Base = ColsGeo<N_, E, ring_cols(N_, E, S, sizeof(T)), S>;
  static constexpr int BUFS = S < 2 ? 0 : 1;   // the one exchange buffer
  static constexpr int BR = box_rows(N_);
  static constexpr int NBOX = N_ / BR;
  static constexpr size_t RAW = round128(2 * sizeof(T) * N_ * Base::C);
  static constexpr size_t XCH = BUFS * Base::BUF;
  static constexpr int K = ring_depth(N_, Base::C, S, sizeof(T));
  static constexpr size_t SMEM = K * RAW + XCH + SMEM_ALIGN;
  static_assert(K >= 1 && Base::C * sizeof(T) >= 16 && Base::C <= 256,
                "ring geometry");
};

// What a thread of the axis ring works on: cols_stage's fields, stage 0
// reading the landed slab (lr, li), and the slab's ring state: release()
// arrives on the slab's `empty` mbarrier once the thread has read the
// slab; refill() (after stage 0, where few registers are live) has thread
// 0 wait for that barrier and issue item (rx, ry) into the slab (ry < 0:
// none).
template <typename T, class G>
struct RingIO {
  using Elem = T;
  static constexpr bool RING = true;
  static constexpr bool STORE = false;
  const T* lr;
  const T* li;
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
  uint64_t* full;
  uint64_t* empty;
  unsigned phase;
  const CUtensorMap* mr;
  const CUtensorMap* mi;
  int rx, ry;

  __device__ __forceinline__ void release() const { mbar_arrive(empty); }

  __device__ __forceinline__ void refill() const {
    if (threadIdx.x == 0 && ry >= 0) {
      mbar_wait(empty, phase);
      load_tiles(const_cast<T*>(lr), const_cast<T*>(li), mr, mi, rx, ry,
                 G::NBOX, G::BR, G::C, full);
    }
  }
};

template <typename T, class G, int... R>
__global__ void __launch_bounds__(G::THREADS, 1)
fft_axis_ring_kernel(const __grid_constant__ CUtensorMap mr,
                     const __grid_constant__ CUtensorMap mi,
                     T* __restrict__ yr, T* __restrict__ yi, long long V,
                     int ntiles, long long items,
                     const float2* __restrict__ tw, float s, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[G::K], empty[G::K];
  unsigned char* const smem = aligned_smem(smem_raw);
  const long long first = blockIdx.x;
  const int count =
      first < items ? (int)((items - 1 - first) / gridDim.x + 1) : 0;
  auto slab = [&](int b) {
    return reinterpret_cast<T*>(smem + (size_t)b * G::RAW);
  };
  // item i: its first column x and first row y in the (pre*n, V) view
  auto where = [&](int i, int& x, int& y) {
    const long long id = first + (long long)i * gridDim.x;
    const long long pl = id / ntiles;
    x = (int)(id - pl * ntiles) * G::C;
    y = (int)pl * G::N;
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < G::K; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], G::THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < G::K && i < count; ++i) {
      int x, y;
      where(i, x, y);
      load_tiles(slab(i), slab(i) + G::N * G::C, &mr, &mi, x, y, G::NBOX,
                 G::BR, G::C, &full[i]);
    }
  float* const xs = reinterpret_cast<float*>(smem + (size_t)G::K * G::RAW);
  RingIO<T, G> io;
  io.yr = yr;
  io.yi = yi;
  io.ld = (size_t)V;
  io.lane = threadIdx.x >> G::LC;
  io.c = threadIdx.x & (G::C - 1);
  io.sr[0] = io.sr[1] = xs;
  io.si[0] = io.si[1] = xs + G::WORDS;
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  io.mr = &mr;
  io.mi = &mi;
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    const int b = i % G::K;
    int x, y;
    where(i, x, y);
    const long long col = (long long)x + io.c;
    io.valid = col < V;
    io.off = (size_t)y * V + (size_t)col;
    io.lr = slab(b);
    io.li = io.lr + G::N * G::C;
    io.full = &full[b];
    io.empty = &empty[b];
    io.phase = (unsigned)(i / G::K) & 1u;
    io.ry = -1;
    if (i + G::K < count) where(i + G::K, io.rx, io.ry);
    mbar_wait(&full[b], io.phase);
    cols_stage<RingIO<T, G>, G, 0, 1, 0, R...>(io);
  }
}

template <int R0, int... R>
constexpr int first_of() {
  return R0;
}

// The ring's geometry for an instance of the COLS_CASE table: its length
// and stage list (the table's E and tile widths are fft_cols').
template <typename T, int N, int E, int CF, int CB, int... R>
using RingGeoOf =
    RingGeo<T, N, ring_values(N, first_of<R...>(), sizeof(T)), sizeof...(R)>;

// Launch the instance on (pre, N, V) planes; the host's stage list must be
// the instance's (cols_stages).
template <typename T, int N, int E, int CF, int CB, int... R>
cudaError_t launch_axis_list(ColsList<N, E, CF, CB, R...> list,
                             const T* xr, const T* xi, T* yr, T* yi,
                             long long pre, long long V, int sign,
                             float scale, const float2* tw, int nstages,
                             const int* radices, void* stream) {
  if (!cols_list_ok(list, nstages, radices)) return cudaErrorInvalidValue;
  if (V % (16 / (long long)sizeof(T)) || pre * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (pre <= 0 || V <= 0) return cudaSuccess;
  using G = RingGeoOf<T, N, E, CF, CB, R...>;
  const long long ntiles = (V + G::C - 1) / G::C;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long items = pre * ntiles;
  const void* fn = (const void*)fft_axis_ring_kernel<T, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, G::THREADS,
                                                      G::SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  CUtensorMap mr, mi;
  if ((e = tensor_map(&mr, xr, pre * N, V, G::C, G::BR)) != cudaSuccess
      || (e = tensor_map(&mi, xi, pre * N, V, G::C, G::BR)) != cudaSuccess)
    return e;
  long long grid = (long long)sms * per_sm;
  if (grid > items) grid = items;
  fft_axis_ring_kernel<T, G, R...><<<(unsigned)grid, G::THREADS, G::SMEM,
                                     (cudaStream_t)stream>>>(
      mr, mi, yr, yi, V, (int)ntiles, items, tw, (float)sign, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_axis(const T* xr, const T* xi, T* yr, T* yi, long long pre,
                        int n, int V, int sign, float scale, const float2* tw,
                        int nstages, const int* radices, void* stream) {
  return with_cols_list(n, [&](auto list) {
    return launch_axis_list(list, xr, xi, yr, yi, pre, (long long)V, sign,
                            scale, tw, nstages, radices, stream);
  });
}

// out = {resident blocks an SM, columns a tile, threads a block, registers
// a thread, shared bytes a block, ring depth K}.
template <typename T, int N, int E, int CF, int CB, int... R>
cudaError_t axis_residency_list(ColsList<N, E, CF, CB, R...>, int* out) {
  using G = RingGeoOf<T, N, E, CF, CB, R...>;
  const void* fn = (const void*)fft_axis_ring_kernel<T, G, R...>;
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
  out[5] = G::K;
  return cudaSuccess;
}

// --------------------------------------------------------------------------
// fuse_last mode
// --------------------------------------------------------------------------
// Sub-slabs a stripe of w columns of T: S = 2 where each half-stripe row
// makes a TMA box row (at most 256 elements, a multiple of 16 bytes and of
// 4 elements, for the gather's 16-byte loads), else 1 where the whole row
// does, else 4 (w = 640..1024: the stripes of short columns).
__host__ __device__ constexpr bool axes2_row_ok(int ws, int es) {
  return ws <= 256 && ws % 4 == 0 && (ws * es) % 16 == 0;
}

template <typename T>
int axes2_subslabs(int w) {
  constexpr int es = sizeof(T);
  if (w % 2 == 0 && axes2_row_ok(w / 2, es)) return 2;
  if (axes2_row_ok(w, es)) return 1;
  if (w % 4 == 0 && axes2_row_ok(w / 4, es)) return 4;
  return 0;
}

// Calls f(std::integral_constant<int, S>{}) with the stripe's sub-slab
// count; cudaErrorInvalidValue where no count fits.
template <typename T, class F>
cudaError_t with_subslabs(int w, F&& f) {
  switch (axes2_subslabs<T>(w)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

// Words of the re (or im) part of a CTA's shared memory: fft_fused2's
// stripe and padded rows (fused2_smem), rounded up to 32 words so that the
// im part starts on a 128-byte boundary, as every TMA box's place must.
__host__ __device__ int axes2_part(int n1, int n2, int C) {
  const int h = n1 / C;
  const int words = h * n2 / 2 + h * (n2 + n2 / 32);
  return (words + 31) / 32 * 32;
}

// The kernel's dynamic shared memory for (n1, n2) planes in clusters of C,
// or 0 when fft_fused2 does not take the geometry or it does not fit.
template <int S>
size_t axes2_smem(int n1, int n2, int C) {
  if (!fused2_smem(n1, n2, C)) return 0;
  const size_t bytes =
      2 * sizeof(float) * (size_t)axes2_part(n1, n2, C) + SMEM_ALIGN;
  const size_t fixed = 2 * sizeof(F2Stages) + S * sizeof(uint64_t);
  return bytes + fixed <= F2_MAX_SMEM ? bytes : 0;
}

// Widen one part of a bf16 sub-slab (`words` elements at raw) into its f32
// place f; the raw bytes lie in the upper half of that place, so every
// thread reads its 16-byte groups into registers before the barrier and
// writes them after.  Enters and leaves on a block barrier.
template <int ELEMS>
__device__ __forceinline__ void widen(const __nv_bfloat16* raw, float* f,
                                      int words) {
  constexpr int G = ELEMS / 8;   // 8-element groups a thread
  uint4 a[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = threadIdx.x + k * F2_THREADS;
    if (8 * g < words) a[k] = reinterpret_cast<const uint4*>(raw)[g];
  }
  __syncthreads();
  auto put = [](float* f, const uint4& u) {
    const unsigned v[4] = {u.x, u.y, u.z, u.w};
    float o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v[i]));
      o[2 * i] = p.x;
      o[2 * i + 1] = p.y;
    }
    reinterpret_cast<float4*>(f)[0] = make_float4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<float4*>(f)[1] = make_float4(o[4], o[5], o[6], o[7]);
  };
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = threadIdx.x + k * F2_THREADS;
    if (8 * g < words) put(f + 8 * g, a[k]);
  }
  __syncthreads();
}

template <typename T, int S>
__global__ void __launch_bounds__(F2_THREADS, 1)
fft_axes2_ring_kernel(const __grid_constant__ CUtensorMap mr,
                      const __grid_constant__ CUtensorMap mi,
                      T* __restrict__ yr, T* __restrict__ yi, long long P,
                      StagePlan p1, const float2* __restrict__ tw1,
                      StagePlan p2, const float2* __restrict__ tw2, int C,
                      int brows, float s, float scale) {
  constexpr bool WIDEN = !std::is_same<T, float>::value;
  constexpr int ELEMS = F2_ELEMS / S;   // values a thread a column stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ F2Stages plan[2];
  __shared__ __align__(8) uint64_t full[S];
  float* const smem = reinterpret_cast<float*>(aligned_smem(smem_raw));
  if (threadIdx.x == 0) f2_copy(plan[0], p1);
  if (threadIdx.x == 1) f2_copy(plan[1], p2);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int n1 = p1.n, n2 = p2.n, w = n2 / C, h = n1 / C, ws = w / S;
  const int N = n1 * ws;        // words of a sub-slab's re (im) part
  const int rb = h * n2 / 2;    // the rows' first word
  float* const sr = smem;
  float* const si = smem + axes2_part(n1, n2, C);
  const int nbox = n1 / brows;
  // where sub-slab `sub` lands: its f32 place, or the upper half of it
  auto land = [=](float* part, int sub) {
    T* p = reinterpret_cast<T*>(part + sub * N);
    return WIDEN ? p + N : p;
  };
  // thread 0: the copies of sub-slab `sub` of plane pl
  const CUtensorMap* const pmr = &mr;
  const CUtensorMap* const pmi = &mi;
  auto issue = [=](int sub, long long pl) {
    fence_async_shared();
    load_tiles(land(sr, sub), land(si, sub), pmr, pmi, c * w + sub * ws,
               (int)(pl * n1), nbox, brows, ws, &full[sub]);
  };
  if (threadIdx.x == 0) {
    for (int sub = 0; sub < S; ++sub) mbar_init(&full[sub], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long nclus = gridDim.x / C, q = blockIdx.x / C;
  if (threadIdx.x == 0 && q < P)
    for (int sub = 0; sub < S; ++sub) issue(sub, q);
  float* const rr = sr + rb;
  float* const ri = si + rb;
  auto rows_st = [=](int x, float re, float im) {
    rr[f2_pad<true>(x)] = re;
    ri[f2_pad<true>(x)] = im;
  };
  const int ns1 = plan[0].nstages, ns2 = plan[1].nstages;
  unsigned parity = 0;
#pragma unroll 1
  for (long long pl = q; pl < P; pl += nclus, parity ^= 1u) {
    const bool more = pl + nclus < P;
    // 1. the column pass, sub-slab by sub-slab as each lands: ws transforms
    // of n1 points each
    for (int sub = 0; sub < S; ++sub) {
      mbar_wait(&full[sub], parity);
      float* const cr = sr + sub * N;
      float* const ci = si + sub * N;
      if constexpr (WIDEN) {
        widen<ELEMS>(land(sr, sub), cr, N);
        widen<ELEMS>(land(si, sub), ci, N);
      }
      auto stripe_st = [=](int x, float re, float im) {
        cr[x] = re;
        ci[x] = im;
      };
      for (int st = 0; st < ns1; ++st) {
        f2_stage_of<true, ELEMS>(plan[0], st, cr, ci, ws, ws, tw1, s,
                                 stripe_st, true);
        if (st + 1 < ns1) __syncthreads();
      }
    }
    fence_async_shared();   // the stripe's writes before the next copies
    cluster.sync();   // every stripe complete and visible to the cluster
    // 2. gather rows [c*h, (c+1)*h), 16 B a load: element i of row t is in
    // CTA i/w, column q = i%w of the stripe, in sub-slab q/ws
    {
      const int nq = n2 >> 2, ng = h * nq, hg = ng >> 1;
      const unsigned im_off = 4u * (unsigned)(si - sr);
      constexpr int HG = F2_GROUPS / 2;
      float4 a[HG], b[HG];
      auto fetch = [=](int g, float4& ra, float4& ia) {
        const int t = div_by(g, nq), i = 4 * (g - t * nq);
        const int seg = div_by(i, w), col = i - seg * w;
        const int sub = S == 1 ? 0 : S == 2 ? (col >= ws) : div_by(col, ws);
        const unsigned at = f2_remote(
            sr + sub * N + (c * h + t) * ws + col - sub * ws, seg);
        ra = f2_ld_remote(at);
        ia = f2_ld_remote(at + im_off);
      };
      auto put = [=](int g, const float4& ra, const float4& ia) {
        const int o = rb + f2_pad<true>(4 * g);
        sr[o] = ra.x; sr[o + 1] = ra.y; sr[o + 2] = ra.z; sr[o + 3] = ra.w;
        si[o] = ia.x; si[o + 1] = ia.y; si[o + 2] = ia.z; si[o + 3] = ia.w;
      };
#pragma unroll
      for (int k = 0; k < HG; ++k)   // past the end: repeat the last group
        fetch(min(hg + threadIdx.x + k * F2_THREADS, ng - 1), a[k], b[k]);
#pragma unroll
      for (int k = 0; k < HG; ++k) {
        const int g = hg + threadIdx.x + k * F2_THREADS;
        if (g < ng) put(g, a[k], b[k]);
      }
#pragma unroll
      for (int k = 0; k < HG; ++k)
        fetch(min(threadIdx.x + k * F2_THREADS, hg - 1), a[k], b[k]);
      cluster.sync();   // every CTA has read all it needs of the others
      // the stripe's part below the rows is free: the next plane's
      // sub-slabs that lie there go out now
      if (threadIdx.x == 0 && more)
        for (int sub = 0; sub < S; ++sub)
          if ((sub + 1) * N <= rb) issue(sub, pl + nclus);
#pragma unroll
      for (int k = 0; k < HG; ++k) {
        const int g = threadIdx.x + k * F2_THREADS;
        if (g < hg) put(g, a[k], b[k]);
      }
    }
    __syncthreads();
    // 3. the row pass: h transforms of n2 points, the last stage to memory
    T* const gyr = yr + (size_t)pl * n1 * n2 + (size_t)c * h * n2;
    T* const gyi = yi + (size_t)pl * n1 * n2 + (size_t)c * h * n2;
    auto out_st = [=](int x, float re, float im) {
      gyr[x] = from_f32<T>(re * scale);
      gyi[x] = from_f32<T>(im * scale);
    };
    for (int st = 0; st + 1 < ns2; ++st) {
      f2_stage_of<false>(plan[1], st, rr, ri, n2, h, tw2, s, rows_st, true);
      __syncthreads();
    }
    fence_async_shared();   // the rows' writes before the next copies
    // the last stage's barrier (sync) follows its reads: after it the rows
    // are in registers, and the rest of the next plane's sub-slabs go out
    // while the stores drain
    f2_stage_of<false>(plan[1], ns2 - 1, rr, ri, n2, h, tw2, s, out_st, true);
    if (threadIdx.x == 0 && more)
      for (int sub = 0; sub < S; ++sub)
        if ((sub + 1) * N > rb) issue(sub, pl + nclus);
  }
}

template <typename T, int S>
cudaError_t launch_axes2(const T* xr, const T* xi, T* yr, T* yi, long long P,
                         int C, StagePlan& p1, const float2* tw1,
                         StagePlan& p2, const float2* tw2, float s,
                         float scale, cudaStream_t stream) {
  const int n1 = p1.n, n2 = p2.n;
  const size_t smem = axes2_smem<S>(n1, n2, C);
  if (!smem || P * n1 > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (P <= 0) return cudaSuccess;
  const void* fn = (const void*)fft_axes2_ring_kernel<T, S>;
  int active = 0;
  cudaError_t e = fused2_clusters(fn, C, smem, &active);
  if (e != cudaSuccess) return e;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  int brows = box_rows(n1);
  CUtensorMap mr, mi;
  const int ws = n2 / C / S;
  if ((e = tensor_map(&mr, xr, P * n1, n2, ws, brows)) != cudaSuccess
      || (e = tensor_map(&mi, xi, P * n1, n2, ws, brows)) != cudaSuccess)
    return e;
  const long long nclus = P < active ? P : active;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(nclus * C));
  cfg.blockDim = dim3(F2_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&mr, &mi, &yr, &yi, &P, &p1, &tw1, &p2, &tw2, &C, &brows,
                  &s, &scale};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int axes2_ring(const T* xr, const T* xi, T* yr, T* yi, long long P, int n1,
               int n2, int C, int sign, float scale, const float2* tw1,
               int nstages1, const int* radices1, const float2* tw2,
               int nstages2, const int* radices2, void* stream) {
  StagePlan p1, p2;
  if (make_plan(n1, nstages1, radices1, &p1)
      || make_plan(n2, nstages2, radices2, &p2) || C < 1 || n2 % C)
    return cudaErrorInvalidValue;
  const float s = (float)sign;
  return with_subslabs<T>(n2 / C, [&](auto sub) {
    return launch_axes2<T, decltype(sub)::value>(
        xr, xi, yr, yi, P, C, p1, tw1, p2, tw2, s, scale,
        (cudaStream_t)stream);
  });
}

template <typename T>
int axes2_clusters(int n1, int n2, int C) {
  if (C < 1 || n2 % C) return -(int)cudaErrorInvalidValue;
  int count = 0;
  const cudaError_t e = with_subslabs<T>(n2 / C, [&](auto sub) {
    constexpr int S = decltype(sub)::value;
    const size_t smem = axes2_smem<S>(n1, n2, C);
    if (!smem) return cudaErrorInvalidValue;
    return fused2_clusters((const void*)fft_axes2_ring_kernel<T, S>, C, smem,
                           &count);
  });
  return e == cudaSuccess ? count : -(int)e;
}

}  // namespace

extern "C" {

// FFT along the middle axis of (pre, n, post) f32 planes through the slab
// ring; radices from cols_stages, post % 4 == 0, 16-byte aligned planes.
int fft_axis_ring(const float* xr, const float* xi, float* yr, float* yi,
                  long long pre, int n, int post, int sign, float scale,
                  const float2* tw, int nstages, const int* radices,
                  void* stream) {
  return launch_axis(xr, xi, yr, yi, pre, n, post, sign, scale, tw, nstages,
                     radices, stream);
}

// The same on bf16 planes (f32 compute); post % 8 == 0.
int fft_axis_ring_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                       __nv_bfloat16* yr, __nv_bfloat16* yi, long long pre,
                       int n, int post, int sign, float scale,
                       const float2* tw, int nstages, const int* radices,
                       void* stream) {
  return launch_axis(xr, xi, yr, yi, pre, n, post, sign, scale, tw, nstages,
                     radices, stream);
}

// The residency of the axis ring's instance for length n (bf16 != 0: its
// bf16 instance): out[6] = {resident blocks an SM, columns a tile, threads
// a block, registers a thread, shared bytes a block, ring depth}.  Returns
// the CUDA error code (cudaErrorInvalidValue for a length with no
// instance).
int fft_axis_ring_residency(int n, int bf16, int* out) {
  return with_cols_list(n, [&](auto list) {
    return bf16 ? axis_residency_list<__nv_bfloat16>(list, out)
                : axis_residency_list<float>(list, out);
  });
}

// FFT along both trailing axes of (P, n1, n2) f32 planes, one plane at a
// time per cluster of C CTAs (fused2_cluster), persistent clusters;
// radices from fused2_stages, 16-byte aligned planes.
int fft_axes2_ring(const float* xr, const float* xi, float* yr, float* yi,
                   long long P, int n1, int n2, int C, int sign, float scale,
                   const float2* tw1, int nstages1, const int* radices1,
                   const float2* tw2, int nstages2, const int* radices2,
                   void* stream) {
  return axes2_ring(xr, xi, yr, yi, P, n1, n2, C, sign, scale, tw1, nstages1,
                    radices1, tw2, nstages2, radices2, stream);
}

// The same on bf16 planes (f32 compute, the f32 intermediate on chip).
int fft_axes2_ring_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                        __nv_bfloat16* yr, __nv_bfloat16* yi, long long P,
                        int n1, int n2, int C, int sign, float scale,
                        const float2* tw1, int nstages1, const int* radices1,
                        const float2* tw2, int nstages2, const int* radices2,
                        void* stream) {
  return axes2_ring(xr, xi, yr, yi, P, n1, n2, C, sign, scale, tw1, nstages1,
                    radices1, tw2, nstages2, radices2, stream);
}

// cudaOccupancyMaxActiveClusters of the fuse_last instance (bf16 != 0: its
// bf16 instance) for (n1, n2) planes in clusters of C: the persistent grid's
// cluster count at most; minus the CUDA error code if the geometry is
// refused or the query fails.
int fft_axes2_ring_clusters(int n1, int n2, int C, int bf16) {
  return bf16 ? axes2_clusters<__nv_bfloat16>(n1, n2, C)
              : axes2_clusters<float>(n1, n2, C);
}

}  // extern "C"
