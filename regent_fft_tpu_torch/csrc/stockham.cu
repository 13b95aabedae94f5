// Self-sorting Stockham C2C FFT kernels for Hopper (sm_90a) on split re/im
// planes: f32 (complex64) or bf16 (complex32).  fft_fused2_kernel runs a
// thread-block cluster a plane (also the gap pass's strided plane, below;
// its body is fused2.cuh) and fft_last_kernel holds rows in registers (the
// row body of last.cuh, which real.cu's pair kernels share):
//
//   fft_last_kernel<T,n,R...> replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_last
//   fft_fused2_kernel<T,false> replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_fused2
//   fft_fused2_kernel<T,true>  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_fused2_gap
//
// Each computes one DFT along an axis (two for fused2 and gap) with the norm
// scale fused into the final write.  The mid-axis pass (fft_cols,
// fft_cols_bf16, fft_axis0) is cols.cu's fft_cols_kernel and the four-step
// column passes (fft_cols_tw, the a0fs stages) fourstep.cu's instances of
// the same column body, sources of their own so that their instances
// compile beside these.
//
// The bf16 instances (C entries fft_last_bf16,
// fft_fused2_bf16, fft_gap_bf16) replace the same runners with io="bf16",
// whose
// bodies on the TPU are _direct_tile (a dense DFT_n MXU dot, n <= 512),
// _mxu_tile_tw (the twiddle-folded four-step, n = 1024 and 2048) and
// _stockham_tile with bf16 blocks (every other length).  The TPU used the
// MXU because its vector unit is weak; on this card a dense DFT_n costs
// 6*n flops per element in 3M form (3072 at n = 512) against ~5*log2(n) for
// the butterflies, and the f32 kernels are bytes-bound well below the FP32
// ridge, so the bf16 instances run the same f32 FFMA butterflies as the
// f32 ones on bf16 blocks: each element is read as 4 B (bf16 re + im)
// instead of 8 and written the same, converted to f32 on load and rounded
// to nearest even on the store.
// Bound on H100 for them: bytes, 8 B per complex element per pass (half the
// f32 kernels' 16 B).  The two-axis kernels keep the plane between their
// column and row passes in f32, as the TPU kernels do in VMEM.
// fft_fused2_kernel holds it on chip: one plane per thread-block cluster,
// each CTA a stripe of it in shared memory, the row pass gathering its rows
// through distributed shared memory, so each element crosses device memory
// once each way (16 B in f32, 8 B in bf16: the function's own bound) and
// the wrapper allocates nothing but the output.  The gap pass (C entries
// fft_gap, fft_gap_bf16; its TPU body is _stockham_tile on either block
// type) is the same kernel on the strided (z, x) planes of (B, z, Y, x)
// data: its GAP instance only places a plane and spaces its rows Y*x
// elements apart, so it too moves 16 B (8 B in bf16) per element.

#include <cooperative_groups.h>

#include "stockham_tile.cuh"
#include "radix.cuh"
#include "fused2.cuh"
#include "last.cuh"

namespace cg = cooperative_groups;

namespace {

// --------------------------------------------------------------------------
// fft_fused2_kernel — replaces pallas_stockham.py:_runner_fused2 (FFT along
// both trailing axes of (P, n1, n2) planes, scale fused; f32 or bf16 planes,
// the intermediate in f32, the output rounded once to the input's type) and,
// as its GAP instance, pallas_stockham.py:_runner_fused2_gap (FFT along axes
// 1 and 3 of (B, n1, Y, n2) data: the same transform of the (b, y) plane at
// b*n1*Y*n2 + y*n2, whose rows are ld = Y*n2 elements apart, 1 MiB in f32 at
// 512^3).
// Bound on H100: bytes.  Each element is read once and written once (16 B
// in f32, 8 B in bf16: 0.641 / 0.3205 ms at 512^3), ~5*log2(n1*n2) flops
// per element, far below the FP32 ridge.  A plane is up to 262144 complex
// elements, 2 MiB in f32: more than the 227 KB a block can use, so the
// TPU's VMEM-resident plane becomes a cluster-resident one.
// Design: one plane per thread-block cluster of C CTAs (C = 1..16, a power
// of two chosen by the host, ops/stockham_kernels.py:fused2_cluster, so that
// a CTA holds at most F2_CTA_ELEMS elements; 16 is a non-portable size).
//   1. Column pass.  CTA c copies the stripe of columns [c*w, (c+1)*w),
//      w = n2/C, from device memory into its shared memory (4 elements a
//      load: 16 B in f32, 8 B in bf16), transforms it along n1 in place,
//      and keeps it there in f32 (n1 x w, row-major).
//   2. cluster.sync(): release/acquire at cluster scope, the barrier
//      between the CTAs; every stripe is then readable through distributed
//      shared memory.
//   3. Row pass.  CTA c takes rows [c*h, (c+1)*h), h = n1/C, 16 B a load
//      through distributed shared memory (element j of a row is in CTA j/w
//      at column j%w, and w is a multiple of 8).  The rows sit half a
//      stripe above the stripe, one pad word every 32: their upper half is
//      written at once, their lower half, which covers the stripe's upper
//      half, is held in registers until a second cluster.sync() says every
//      CTA has read all it needs.  It transforms them along n2 in place;
//      the last stage writes to device memory with the scale, in natural
//      order (neighbouring threads on neighbouring elements of a row).  No
//      CTA touches another's memory after that barrier, so none waits for
//      the others to exit.
//   4. Butterflies in registers: a stage of radix R gives each thread whole
//      R-point butterflies (fused2_stages: radix 8 where it can, so 512
//      points take 3 exchanges of shared memory, not 5), each read,
//      twiddled and transformed before the block barrier and written after
//      it: a thread holds about F2_ELEMS = 32 values of a stage, 512
//      threads in at most 128 registers each, one CTA an SM.
// Twiddles: the float64-generated table of the stage list, as every kernel.
// The host checks the geometry and asks cudaOccupancyMaxActiveClusters once
// per (kernel, C, shared memory) and refuses to launch when no cluster fits.
// The GAP instance differs only where a plane meets device memory: cluster
// q = blockIdx.x / C takes plane (b, y) = (q / Y, q % Y), the stripe loads
// and the CTA's first output row step by ld instead of n2, and the last row
// stage's store turns the row-major index X = t*n2 + i it is given into
// t*ld + i.  Neighbouring clusters take neighbouring y, so their stripe
// rows (w elements, 128 B in f32 at 512^3) sit n2 elements apart.  Nothing
// else changes, and the fused2 instance (GAP false, ld = n2) compiles the
// code it had before the gap pass joined it.  The whole strided plane sits
// in the cluster, so the TPU kernel's VMEM strip rule (REGENT_FFT_GAP_STRIPS)
// has no counterpart here.
// --------------------------------------------------------------------------

// Four consecutive elements from device memory as f32 (16-byte load for
// f32, 8-byte for bf16; the caller keeps them aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, bool GAP>
__global__ void __launch_bounds__(F2_THREADS, 1)
fft_fused2_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                  T* __restrict__ yr, T* __restrict__ yi, StagePlan p1,
                  const float2* __restrict__ tw1, StagePlan p2,
                  const float2* __restrict__ tw2, int C, int Y, float s,
                  float scale) {
  extern __shared__ float smem[];   // dynamic: 16-byte aligned
  __shared__ F2Stages plan[2];      // published by the barrier after step 1
  if (threadIdx.x == 0) f2_copy(plan[0], p1);
  if (threadIdx.x == 1) f2_copy(plan[1], p2);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int n1 = p1.n, n2 = p2.n, w = n2 / C, h = n1 / C;
  const int rb = h * n2 / 2;                  // the rows' first word
  const int part = rb + h * (n2 + n2 / 32);   // words of the re (im) part
  float* sr = smem;
  float* si = smem + part;
  // the plane's first element, and the distance between its rows (the
  // host keeps Y*n2 below 2^31; offsets are 64-bit)
  size_t plane;
  int ld = n2;
  if constexpr (GAP) {
    const int q = blockIdx.x / C, b = q / Y;
    ld = Y * n2;
    plane = (size_t)b * n1 * ld + (size_t)(q - b * Y) * n2;
  } else {
    plane = (size_t)(blockIdx.x / C) * n1 * n2;
  }

  // 1. the stripe, 4 elements a load, in two batches of loads then stores
  {
    const T* gxr = xr + plane + (size_t)c * w;
    const T* gxi = xi + plane + (size_t)c * w;
    const int wq = w >> 2, ng = n1 * wq;
    constexpr int HG = F2_GROUPS / 2;
#pragma unroll
    for (int k0 = 0; k0 < F2_GROUPS; k0 += HG) {
      float4 a[HG], b[HG];
#pragma unroll
      for (int k = 0; k < HG; ++k) {   // past ng: repeat group ng - 1
        const int g = min(threadIdx.x + (k0 + k) * F2_THREADS, ng - 1);
        const int j = div_by(g, wq);
        const size_t o = (size_t)j * ld + 4 * (g - j * wq);
        a[k] = load4(gxr + o);
        b[k] = load4(gxi + o);
      }
#pragma unroll
      for (int k = 0; k < HG; ++k) {
        const int g = threadIdx.x + (k0 + k) * F2_THREADS;
        if (g < ng) {   // row j, column 4*q of the stripe: j*w + 4*q = 4*g
          *reinterpret_cast<float4*>(sr + 4 * g) = a[k];
          *reinterpret_cast<float4*>(si + 4 * g) = b[k];
        }
      }
    }
  }
  __syncthreads();
  // 2. the column pass over the stripe: w transforms of n1 points
  auto stripe_st = [=](int x, float re, float im) {
    sr[x] = re;
    si[x] = im;
  };
  const int ns1 = plan[0].nstages, ns2 = plan[1].nstages;
  for (int st = 0; st < ns1; ++st) {
    f2_stage_of<true>(plan[0], st, sr, si, w, w, tw1, s, stripe_st, true);
    if (st + 1 < ns1) __syncthreads();
  }
  cluster.sync();   // every stripe complete and visible to the cluster
  // 3. gather rows [c*h, (c+1)*h), 16 B a load from the owning stripes:
  // element i of row t is in CTA i/w at (c*h + t)*w + i%w (w % 8 == 0).
  // Group g is X = 4g .. 4g+3 (one pad word for all four); the upper half
  // of the groups goes to the rows at once, the lower half after the
  // cluster barrier.
  {
    const int nq = n2 >> 2, ng = h * nq, hg = ng >> 1;
    const unsigned im_off = 4u * part;   // si - sr in bytes
    constexpr int HG = F2_GROUPS / 2;
    float4 a[HG], b[HG];
    auto fetch = [=](int g, float4& ra, float4& ia) {
      const int t = div_by(g, nq), i = 4 * (g - t * nq);
      const int seg = div_by(i, w);
      const unsigned at = f2_remote(sr + (c * h + t) * w + i - seg * w, seg);
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
#pragma unroll
    for (int k = 0; k < HG; ++k) {
      const int g = threadIdx.x + k * F2_THREADS;
      if (g < hg) put(g, a[k], b[k]);
    }
  }
  __syncthreads();
  // 4. the row pass: h transforms of n2 points, the last stage to memory
  float* rr = sr + rb;
  float* ri = si + rb;
  auto rows_st = [=](int x, float re, float im) {
    rr[f2_pad<true>(x)] = re;
    ri[f2_pad<true>(x)] = im;
  };
  T* gyr = yr + plane + (size_t)c * h * ld;    // the CTA's first row
  T* gyi = yi + plane + (size_t)c * h * ld;
  // x = t*n2 + i names element i of the CTA's row t; GAP rows are ld
  // apart, so t = x / n2 by a multiply-high, exact for x < 2^14 (x < h*n2
  // <= F2_CTA_ELEMS) with mag = ceil(2^32 / n2)
  const unsigned mag = 0xffffffffu / n2 + 1, skip = ld - n2;
  auto out_st = [=](int x, float re, float im) {
    size_t o = x;
    if constexpr (GAP) o += (size_t)__umulhi((unsigned)x, mag) * skip;
    gyr[o] = from_f32<T>(re * scale);
    gyi[o] = from_f32<T>(im * scale);
  };
  for (int st = 0; st + 1 < ns2; ++st) {
    f2_stage_of<false>(plan[1], st, rr, ri, n2, h, tw2, s, rows_st, true);
    __syncthreads();
  }
  f2_stage_of<false>(plan[1], ns2 - 1, rr, ri, n2, h, tw2, s, out_st, false);
}

// --------------------------------------------------------------------------
// fft_last_kernel — replaces pallas_stockham.py:_runner_last (FFT along the
// last axis of (B, n) planes, norm scale fused into the write; f32 or bf16
// planes, f32 arithmetic, the output rounded once to the input's type).
// Bound on H100: bytes, 16 B per complex element in f32 and 8 B in bf16.
// Design: the register-resident row body of last.cuh in its C2C mode, one
// instance per admitted length (LAST_CASE there), blocks of at most
// LAST_BLOCK threads.
// --------------------------------------------------------------------------
template <typename T, int N, int... R>
__global__ void __launch_bounds__(LAST_BLOCK, LAST_MIN_BLOCKS)
fft_last_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi, long long B,
                const float2* __restrict__ tw, float s, float scale) {
  using G = LastGeo<N, first_radix<R...>()>;
  extern __shared__ float smem[];
  const int rl = threadIdx.x / G::TPR;
  const long long row = (long long)blockIdx.x * G::RPB + rl;
  LastIO<T> io;
  io.xr = xr;
  io.xi = xi;
  io.yr = yr;
  io.yi = yi;
  io.valid = row < B;
  io.off = (size_t)(io.valid ? row : B - 1) * N;
  io.lane = threadIdx.x - rl * G::TPR;
  last_smem_rows<G>(io, smem, rl);
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  last_stage<LastIO<T>, G, N, 0, 1, 0, R...>(io);
}

// Launch the instance on (B, N) planes; the host's stage list must be the
// instance's (the C-side check of last_stages).
template <typename T, int N, int... R>
cudaError_t launch_last_list(LastList<N, R...> list, const T* xr,
                             const T* xi, T* yr, T* yi, long long B, int sign,
                             float scale, const float2* tw, int nstages,
                             const int* radices, void* stream) {
  if (!last_list_ok(list, nstages, radices)) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  constexpr int R0 = first_radix<R...>();
  using G = LastGeo<N, R0>;
  const long long grid = (B + G::RPB - 1) / G::RPB;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = last_smem<N, R0, sizeof...(R)>();
  cudaError_t e = set_smem((const void*)fft_last_kernel<T, N, R...>, smem);
  if (e != cudaSuccess) return e;
  fft_last_kernel<T, N, R...><<<(unsigned)grid, G::THREADS, smem,
                                 (cudaStream_t)stream>>>(
      xr, xi, yr, yi, B, tw, (float)sign, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_last(const T* xr, const T* xi, T* yr, T* yi, long long B,
                        int n, int sign, float scale, const float2* tw,
                        int nstages, const int* radices, void* stream) {
  return with_last_list(n, [&](auto list) {
    return launch_last_list(list, xr, xi, yr, yi, B, sign, scale, tw, nstages,
                            radices, stream);
  });
}

// The residency of the instance (last_residency_of).
template <typename T, int N, int... R>
cudaError_t last_residency_list(LastList<N, R...>, int* out) {
  constexpr int R0 = first_radix<R...>();
  using G = LastGeo<N, R0>;
  return last_residency_of((const void*)fft_last_kernel<T, N, R...>,
                           G::THREADS, G::RPB,
                           last_smem<N, R0, sizeof...(R)>(), out);
}


// The cluster kernel over P planes (n1, n2), or over the B * Y strided
// planes (b, y) of (B, n1, Y, n2) data (GAP; fft_fused2 is Y = 1).
template <typename T, bool GAP>
cudaError_t launch_fused2(const T* xr, const T* xi, T* yr, T* yi, long long P,
                          int Y, int n1, int n2, int C, int sign, float scale,
                          const float2* tw1, int nstages1, const int* radices1,
                          const float2* tw2, int nstages2, const int* radices2,
                          void* stream) {
  StagePlan p1, p2;
  if (make_plan(n1, nstages1, radices1, &p1)
      || make_plan(n2, nstages2, radices2, &p2))
    return cudaErrorInvalidValue;
  const size_t smem = fused2_smem(n1, n2, C);
  if (!smem || Y < 1 || (long long)Y * n2 > 0x7fffffffLL
      || P * Y * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  float fsign = (float)sign;
  if (P <= 0) return cudaSuccess;
  const void* fn = (const void*)fft_fused2_kernel<T, GAP>;
  int active = 0;
  cudaError_t e = fused2_clusters(fn, C, smem, &active);
  if (e != cudaSuccess) return e;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(P * Y * C));
  cfg.blockDim = dim3(F2_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&xr, &xi, &yr, &yi, &p1, &tw1, &p2, &tw2, &C, &Y, &fsign,
                  &scale};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// FFT along the last axis of (B, n) f32 planes; radices from last_stages.
int fft_last(const float* xr, const float* xi, float* yr, float* yi, long long B,
             int n, int sign, float scale, const float2* tw, int nstages,
             const int* radices, void* stream) {
  return launch_last(xr, xi, yr, yi, B, n, sign, scale, tw, nstages, radices,
                     stream);
}

// FFT along the last axis of (B, n) bf16 planes (f32 compute).
int fft_last_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                  __nv_bfloat16* yr, __nv_bfloat16* yi, long long B, int n,
                  int sign, float scale, const float2* tw, int nstages,
                  const int* radices, void* stream) {
  return launch_last(xr, xi, yr, yi, B, n, sign, scale, tw, nstages, radices,
                     stream);
}

// The residency of the fft_last instance for length n (bf16 != 0: its bf16
// instance): out[5] = {resident blocks an SM, rows a block, threads a block,
// registers a thread, shared bytes a block}.  Returns the CUDA error code
// (cudaErrorInvalidValue for a length with no instance).
int fft_last_residency(int n, int bf16, int* out) {
  return with_last_list(n, [&](auto list) {
    return bf16 ? last_residency_list<__nv_bfloat16>(list, out)
                : last_residency_list<float>(list, out);
  });
}

// FFT along both trailing axes of (P, n1, n2) f32 planes, one plane per
// cluster of C CTAs; radices from fused2_stages (8 allowed).
int fft_fused2(const float* xr, const float* xi, float* yr, float* yi,
               long long P, int n1, int n2, int C, int sign, float scale,
               const float2* tw1, int nstages1, const int* radices1,
               const float2* tw2, int nstages2, const int* radices2,
               void* stream) {
  return launch_fused2<float, false>(xr, xi, yr, yi, P, 1, n1, n2, C, sign,
                                     scale, tw1, nstages1, radices1, tw2,
                                     nstages2, radices2, stream);
}

// The same on bf16 planes (f32 compute, f32 intermediate).
int fft_fused2_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                    __nv_bfloat16* yr, __nv_bfloat16* yi, long long P, int n1,
                    int n2, int C, int sign, float scale, const float2* tw1,
                    int nstages1, const int* radices1, const float2* tw2,
                    int nstages2, const int* radices2, void* stream) {
  return launch_fused2<__nv_bfloat16, false>(
      xr, xi, yr, yi, P, 1, n1, n2, C, sign, scale, tw1, nstages1, radices1,
      tw2, nstages2, radices2, stream);
}

// cudaOccupancyMaxActiveClusters of the cluster kernel (bf16 != 0: its
// bf16 instance; gap != 0: the gap pass's strided instance) for (n1, n2)
// planes in clusters of C; minus the CUDA error code if the geometry is
// refused or the query fails.
int fft_fused2_clusters(int n1, int n2, int C, int bf16, int gap) {
  const size_t smem = fused2_smem(n1, n2, C);
  if (!smem) return -(int)cudaErrorInvalidValue;
  const void* fns[2][2] = {
      {(const void*)fft_fused2_kernel<float, false>,
       (const void*)fft_fused2_kernel<float, true>},
      {(const void*)fft_fused2_kernel<__nv_bfloat16, false>,
       (const void*)fft_fused2_kernel<__nv_bfloat16, true>}};
  int count = 0;
  const cudaError_t e =
      fused2_clusters(fns[bf16 != 0][gap != 0], C, smem, &count);
  return e == cudaSuccess ? count : -(int)e;
}

// FFT along axes 1 and 3 of (B, z, Y, x) f32 data, one (b, y) plane per
// cluster of C CTAs; radices from fused2_stages.
int fft_gap(const float* xr, const float* xi, float* yr, float* yi,
            long long B, int z, int Y, int x, int C, int sign, float scale,
            const float2* tw1, int nstages1, const int* radices1,
            const float2* tw2, int nstages2, const int* radices2,
            void* stream) {
  return launch_fused2<float, true>(xr, xi, yr, yi, B, Y, z, x, C, sign,
                                    scale, tw1, nstages1, radices1, tw2,
                                    nstages2, radices2, stream);
}

// The same on bf16 data (f32 compute, the f32 intermediate on chip).
int fft_gap_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                 __nv_bfloat16* yr, __nv_bfloat16* yi, long long B, int z,
                 int Y, int x, int C, int sign, float scale,
                 const float2* tw1, int nstages1, const int* radices1,
                 const float2* tw2, int nstages2, const int* radices2,
                 void* stream) {
  return launch_fused2<__nv_bfloat16, true>(
      xr, xi, yr, yi, B, Y, z, x, C, sign, scale, tw1, nstages1, radices1,
      tw2, nstages2, radices2, stream);
}

}  // extern "C"
