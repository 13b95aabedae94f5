// Real-transform (R2C / C2R) kernels for Hopper (sm_90a) on the shared
// Stockham tile of stockham_tile.cuh:
//
//   fft_last_r2c_kernel   replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_last_r2c
//   ifft_last_c2r_kernel  replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_last_c2r
//
// Both work on the last axis of (B, n) rows, n even, two real rows at a time:
// rows 2p and 2p+1 are the real and imaginary parts of one complex row z, so
// one n-point complex transform serves two real transforms.  An odd B pairs
// the last row with zeros and writes nothing for the missing row.
//
// Half-spectrum layouts (w bins per row):
//   narrow  w = n/2 + 1, bins 0..n/2;
//   packed  w = n/2, bins 0..n/2-1, with the real bin n/2 stored in bin 0's
//           imaginary slot (bin 0 itself is real).
// The JAX package's third, lane-padded (B, n) layout only keeps later TPU
// passes lane-aligned; the port's plan steps take the narrow planes.
//
// What is dropped from the TPU kernels: their reversed-row tail tables
// (_r2c_tables, _fwd_and_rev_spectra) and the c2r permutation-matrix product
// (prev_np) exist because Mosaic cannot flip a sublane axis.  Here the
// frequency reversal k -> (n - k) mod n is an index into shared memory (r2c)
// or into the input row (c2r).

#include "stockham_tile.cuh"

namespace {

// --------------------------------------------------------------------------
// fft_last_r2c_kernel — R2C of (B, n) real rows, scale fused into the write.
// Bound on H100: bytes.  4 B read per real element and 2 * 4 B written per
// output bin (narrow 4096 x 1024: 16.8 MB in + 16.8 MB out, 0.0100 ms at
// 3.35 TB/s; packed 262144 x 256: 268 MB + 268 MB, 0.160 ms), against
// ~2.5*log2(n) flops per real element, far below the FP32 ridge of 20 flop/B.
// Design: a block takes nt row pairs (nt = 8 at n = 1024, 16 at n <= 512),
// so every SM holds enough pairs at 4096 x 1024 and 262144 x 256; the rows
// load coalesced into the tile, the forward tile runs in shared memory, and
// each bin k untangles from Z[k] and Z[(n-k) mod n] read from the tile:
//     X1[k] = (Z[k] + conj Z[-k]) / 2,   X2[k] = (Z[k] - conj Z[-k]) / (2i).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 2)
fft_last_r2c_kernel(const float* __restrict__ x, float* __restrict__ yr,
                    float* __restrict__ yi, long long B, int packed,
                    StagePlan p, const float2* __restrict__ tw, float scale) {
  extern __shared__ float smem[];
  const Geo g = rows_geo(p.n);
  float* sr = smem;
  float* si = smem + g.nt * g.pitch;
  const int n = p.n, m = n >> 1;
  const int w = packed ? m : m + 1;
  const int t = threadIdx.x >> ilog2(g.tj);
  const int jl = threadIdx.x & (g.tj - 1);
  const long long ra = 2 * ((long long)blockIdx.x * g.nt + t);
  const bool va = ra < B, vb = ra + 1 < B;
  for (int j = jl; j < n; j += g.tj) {
    const int a = at<true>(t, j, g);
    sr[a] = va ? x[ra * n + j] : 0.0f;
    si[a] = vb ? x[(ra + 1) * n + j] : 0.0f;
  }
  __syncthreads();
  fft_tile<true>(sr, si, p, tw, -1.0f, t, jl, g);
  if (!va) return;
  for (int k = jl; k < w; k += g.tj) {
    const int a = at<true>(t, k, g);
    const int c = at<true>(t, k ? n - k : 0, g);
    const float zr = sr[a], zi = si[a], cr = sr[c], ci = si[c];
    const float x1r = 0.5f * (zr + cr), x2r = 0.5f * (zi + ci);
    float x1i = 0.5f * (zi - ci), x2i = 0.5f * (cr - zr);
    if (packed && k == 0) {
      // bin n/2 is its own mirror: X1[n/2] = Re Z[n/2], X2[n/2] = Im Z[n/2]
      const int q = at<true>(t, m, g);
      x1i = 0.5f * (sr[q] + sr[q]);
      x2i = 0.5f * (si[q] + si[q]);
    }
    const size_t o = (size_t)ra * w + k;
    yr[o] = x1r * scale;
    yi[o] = x1i * scale;
    if (vb) {
      yr[o + w] = x2r * scale;
      yi[o + w] = x2i * scale;
    }
  }
}

// Bin k (0 <= k <= n/2 = m) of one row's half spectrum, with the imaginary
// parts of bins 0 and m taken as zero (numpy irfft); a missing row is zero.
__device__ __forceinline__ float2 half_bin(const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           long long row, bool valid, int k,
                                           int m, int w, int packed) {
  if (!valid) return make_float2(0.0f, 0.0f);
  const size_t o = (size_t)row * w;
  if (packed && k == m) return make_float2(xi[o], 0.0f);
  if (k == 0 || k == m) return make_float2(xr[o + k], 0.0f);
  return make_float2(xr[o + k], xi[o + k]);
}

// --------------------------------------------------------------------------
// ifft_last_c2r_kernel — n times the inverse of the above: (B, w) half
// spectra -> (B, n) real rows, scale fused into the write.
// Bound on H100: bytes, as above (packed 262144 x 256: 268 MB in + 268 MB
// out, 0.160 ms at 3.35 TB/s).  Design: the same row-pair tiles.  The tile
// is filled with the full spectrum of z = x1 + i*x2,
//     Z[k] = X1[k] + i X2[k]                       k <= n/2,
//     Z[k] = conj X1[n-k] + i conj X2[n-k]         k >  n/2,
// reading bin n-k straight from the input row (a reversed, still contiguous
// run; the second read of each bin comes from L1/L2), then one backward
// tile runs and Re z -> row 2p, Im z -> row 2p+1.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 2)
ifft_last_c2r_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* __restrict__ y, long long B, int packed,
                     StagePlan p, const float2* __restrict__ tw, float scale) {
  extern __shared__ float smem[];
  const Geo g = rows_geo(p.n);
  float* sr = smem;
  float* si = smem + g.nt * g.pitch;
  const int n = p.n, m = n >> 1;
  const int w = packed ? m : m + 1;
  const int t = threadIdx.x >> ilog2(g.tj);
  const int jl = threadIdx.x & (g.tj - 1);
  const long long ra = 2 * ((long long)blockIdx.x * g.nt + t);
  const bool va = ra < B, vb = ra + 1 < B;
  for (int j = jl; j < n; j += g.tj) {
    const int k = j <= m ? j : n - j;
    const float2 x1 = half_bin(xr, xi, ra, va, k, m, w, packed);
    const float2 x2 = half_bin(xr, xi, ra + 1, vb, k, m, w, packed);
    const int a = at<true>(t, j, g);
    if (j <= m) {
      sr[a] = x1.x - x2.y;
      si[a] = x1.y + x2.x;
    } else {
      sr[a] = x1.x + x2.y;
      si[a] = x2.x - x1.y;
    }
  }
  __syncthreads();
  fft_tile<true>(sr, si, p, tw, 1.0f, t, jl, g);
  if (!va) return;
  for (int j = jl; j < n; j += g.tj) {
    const int a = at<true>(t, j, g);
    y[ra * n + j] = sr[a] * scale;
    if (vb) y[(ra + 1) * n + j] = si[a] * scale;
  }
}

// Blocks for B rows: nt row pairs per block.
long long pair_blocks(long long B, int n) {
  const long long pairs = (B + 1) / 2;
  const int nt = rows_geo(n).nt;
  return (pairs + nt - 1) / nt;
}

}  // namespace

extern "C" {

// R2C along the last axis of (B, n) f32 rows -> (B, w) f32 planes.
int fft_last_r2c(const float* x, float* yr, float* yi, long long B, int n,
                 int packed, float scale, const float2* tw, int nstages,
                 const int* radices, void* stream) {
  StagePlan p;
  if (n % 2 || make_plan(n, nstages, radices, &p)) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const size_t smem = rows_smem_bytes(n);
  cudaError_t e = set_smem((const void*)fft_last_r2c_kernel, smem);
  if (e != cudaSuccess) return e;
  fft_last_r2c_kernel<<<(unsigned)pair_blocks(B, n), THREADS, smem,
                        (cudaStream_t)stream>>>(x, yr, yi, B, packed, p, tw,
                                                scale);
  return cudaGetLastError();
}

// n times the inverse: (B, w) f32 half-spectrum planes -> (B, n) f32 rows.
int ifft_last_c2r(const float* xr, const float* xi, float* y, long long B,
                  int n, int packed, float scale, const float2* tw,
                  int nstages, const int* radices, void* stream) {
  StagePlan p;
  if (n % 2 || make_plan(n, nstages, radices, &p)) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const size_t smem = rows_smem_bytes(n);
  cudaError_t e = set_smem((const void*)ifft_last_c2r_kernel, smem);
  if (e != cudaSuccess) return e;
  ifft_last_c2r_kernel<<<(unsigned)pair_blocks(B, n), THREADS, smem,
                         (cudaStream_t)stream>>>(xr, xi, y, B, packed, p, tw,
                                                 scale);
  return cudaGetLastError();
}

}  // extern "C"
