// The mid-axis FFT kernel for Hopper (sm_90a) on split re/im planes, f32
// (complex64) or bf16 (complex32):
//
//   fft_cols_kernel<T,G,R...> replaces regent_fft_tpu/ops/pallas_stockham.py:_runner_cols
//                             (C entries fft_cols, fft_cols_bf16)
//                         and regent_fft_tpu/ops/pallas_stockham.py:_runner_axis0
//                             (C entry fft_axis0: f32, P = 1)
//
// It computes the n-point DFT along the middle axis of (P, n, V) planes,
// element (p, j, v) at (p*n + j)*V + v, with the norm scale fused into the
// write; f32 arithmetic on either plane type, the bf16 output rounded to
// nearest even once, after the scale.
// Bound on H100: bytes.  Each complex element is read once and written once
// (16 B in f32, 8 B in bf16); ~5*log2(n) flops against 16 B is far below
// the FP32 ridge (67 TFLOP/s / 3.35 TB/s = 20 flop/B).  A pass that loads
// its tile into shared memory, runs radix-4 stages there (five full
// passes at n = 512) and then stores keeps memory idle while it computes,
// and a 512-thread tile of n points is 8192 / n columns wide (16 B runs at
// n = 2048), so it is not held by bytes: its bf16 instance takes as long
// as the f32 one.  The design below is fft_last_kernel's (stockham.cu)
// turned on its side:
//   1. Columns in registers, high radix.  A column of n points is held by
//      TPC = n / E threads of E values each: E = 16 up to n = 128 (the
//      first radix where that is 8 or less), E = 32 from n = 160 on, two
//      radix-16 butterflies a thread in the first stages, so that a block
//      of 32 columns of 256 points is 256 threads.  The stage list is
//      cols_stages (ops/stockham_kernels.py): radix 16 while it fits, then
//      the rest of the power of two (2, 4 or 8), then the odd factor (3, 5
//      or 7), so every Ns is a power of two and a power of two up to 2048
//      takes at most two exchanges of shared memory (the mixed lengths
//      three at 1536).  The list is a template pack, one instance per
//      admitted length and plane type (COLS_CASE below); every radix, Ns,
//      butterfly count and twiddle offset is a compile-time constant and
//      the butterflies are straight-line code (Dft<16>, Dft<8>, radix.cuh).
//   2. Device memory straight into registers, the lanes across columns.
//      Thread t of a block takes column c = t % C of the block's C columns
//      and lane j = t / C of that column, so the 32 threads of a warp take
//      min(C, 32) neighbouring columns: every load of stage 0 (element
//      j + r*M of the column, r < R0) and every store of the last stage
//      (j + r*Ns) is a run of C elements along the contiguous axis, C*4 B
//      in f32, C*2 B in bf16.  All of a thread's loads are issued before
//      the first is used.  f32 tiles are 32 columns or more up to n = 512
//      (128 B runs), 16 up to 1024 (64 B); bf16 tiles 32 up to n = 256
//      (64 B), 16 up to 1024 (32 B).  A longer column fits fewer: 16 f32
//      columns of 2048 points are 256 KiB, more than the 227 KiB of shared
//      memory a block has and all of an SM's registers, so n = 1536 and
//      2048 take 8 columns (32 B in f32, 16 B in bf16; bf16 tiles are f32
//      on chip).  The widths are the fastest that scripts/torch_cols_widths.py
//      measured on the card: at n = 512 the f32 tile of 32 columns (one
//      512-thread block an SM) beats two resident 16-column blocks, whose
//      64 B runs cost more than their overlap gains, and in bf16 the two
//      16-column blocks beat one of 32.
//   3. Two tiles in flight an SM where they fit: __launch_bounds__(THREADS,
//      MINB) with MINB = 512 / THREADS blocks (at least one), so that ptxas
//      holds a thread to 65536 / 512 = 128 registers (170 at 192 threads)
//      and spills nothing.  Blocks of 256 threads or fewer (every length up
//      to 256, and 384 and 512 in bf16) are resident two or more at a time,
//      and one block's butterflies overlap another's loads.  The f32 tiles
//      of 384 and 512 points (384 and 512 threads) and every tile from
//      n = 640 on (320-512 threads at 32 values each, 128-224 KiB of
//      shared memory) sit one block an SM: the next block's loads start as
//      this one's stores drain.  chip_smoke.py prints each instance's
//      residency.
//   4. Exchanges: stage s writes its outputs to shared buffer s % BUFS,
//      one block barrier, stage s+1 reads them.  Two buffers (one barrier
//      an exchange) where they fit beside MINB blocks, else one, with a
//      second barrier between an exchange's reads and its writes.  Element
//      x of column c lies at x*C + c when C >= 32 (a warp's accesses are
//      one x, 32 neighbouring columns: no bank conflict); with C < 32 a
//      32-word row holds G = 32/C values of x, their column groups
//      XOR-swizzled by (x ^ x >> 4) % G, which keeps the stride-16 writes
//      of the first stage and the unit-stride reads on distinct banks
//      (tests/test_torch_port_cols_regs.py counts the conflicts).  A stage
//      of radix R gives each thread ceil((n/R) / TPC) butterflies; a thread
//      past the last repeats it and only its stores are dropped.
//   5. The ragged last tile reads column V-1 for its columns at or past V
//      and stores nothing past V.  Offsets are 64-bit: (p*n + j)*V + v
//      passes 2^31 at V = 2^22 for n = 512.
// Twiddles: the float64-generated table of the stage list (_stage_tables),
// as every kernel reads it; no sincospif.
//
// The body (ColsGeo, cols_stage, the COLS_CASE table) is in cols.cuh, which
// the slab ring's axis mode (ring.cu) shares with stage 0 reading a slab
// in shared memory.
//
// Conventions: launched on the caller's stream, never synchronises,
// allocates nothing; each C entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a length with no instance or a stage list that
// is not the instance's.

#include "cols.cuh"

namespace {

// Block b takes columns [(b % ntiles)*C, +C) of plane b / ntiles.
template <typename T, class G, int... R>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
fft_cols_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                T* __restrict__ yr, T* __restrict__ yi, long long V,
                int ntiles, const float2* __restrict__ tw, float s,
                float scale) {
  extern __shared__ float smem[];
  const int c = threadIdx.x & (G::C - 1);
  const unsigned pre = blockIdx.x / (unsigned)ntiles;
  const long long col =
      (long long)(blockIdx.x - pre * (unsigned)ntiles) * G::C + c;
  ColsIO<T> io;
  io.xr = xr;
  io.xi = xi;
  io.yr = yr;
  io.yi = yi;
  io.valid = col < V;
  io.off = (size_t)pre * G::N * (size_t)V + (size_t)(io.valid ? col : V - 1);
  io.ld = (size_t)V;
  io.lane = threadIdx.x >> G::LC;
  io.c = c;
  io.sr[0] = smem;
  io.si[0] = smem + G::WORDS;
  io.sr[1] = smem + 2 * G::WORDS;
  io.si[1] = smem + 3 * G::WORDS;
  io.tw = tw;
  io.s = s;
  io.scale = scale;
  cols_stage<ColsIO<T>, G, 0, 1, 0, R...>(io);
}
// Launch the instance on P (n, V) planes; the host's stage list must be the
// instance's (the C-side check of cols_stages).
template <typename T, int N, int E, int CF, int CB, int... R>
cudaError_t launch_cols_list(ColsList<N, E, CF, CB, R...> list,
                             const T* xr, const T* xi, T* yr, T* yi,
                             long long P, long long V, int sign, float scale,
                             const float2* tw, int nstages,
                             const int* radices, void* stream) {
  if (!cols_list_ok(list, nstages, radices)) return cudaErrorInvalidValue;
  if (P <= 0 || V <= 0) return cudaSuccess;
  using G = ColsGeoOf<T, N, E, CF, CB, R...>;
  const long long ntiles = (V + G::C - 1) / G::C;
  if (P * ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const void* fn = (const void*)fft_cols_kernel<T, G, R...>;
  cudaError_t e = set_smem(fn, G::SMEM);
  if (e != cudaSuccess) return e;
  fft_cols_kernel<T, G, R...><<<(unsigned)(P * ntiles), G::THREADS, G::SMEM,
                                (cudaStream_t)stream>>>(
      xr, xi, yr, yi, V, (int)ntiles, tw, (float)sign, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const T* xr, const T* xi, T* yr, T* yi, long long P,
                        int n, long long V, int sign, float scale,
                        const float2* tw, int nstages, const int* radices,
                        void* stream) {
  return with_cols_list(n, [&](auto list) {
    return launch_cols_list(list, xr, xi, yr, yi, P, V, sign, scale, tw,
                            nstages, radices, stream);
  });
}

// The residency of the instance (cols_residency_of).
template <typename T, int N, int E, int CF, int CB, int... R>
cudaError_t cols_residency_list(ColsList<N, E, CF, CB, R...>, int* out) {
  using G = ColsGeoOf<T, N, E, CF, CB, R...>;
  return cols_residency_of((const void*)fft_cols_kernel<T, G, R...>,
                           G::THREADS, G::C, G::SMEM, out);
}

}  // namespace

extern "C" {

// FFT along the middle axis of (P, n, V) f32 planes; radices from
// cols_stages.
int fft_cols(const float* xr, const float* xi, float* yr, float* yi,
             long long P, int n, int V, int sign, float scale,
             const float2* tw, int nstages, const int* radices,
             void* stream) {
  return launch_cols(xr, xi, yr, yi, P, n, (long long)V, sign, scale, tw,
                     nstages, radices, stream);
}

// FFT along the middle axis of (P, n, V) bf16 planes (f32 compute).
int fft_cols_bf16(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
                  __nv_bfloat16* yr, __nv_bfloat16* yi, long long P, int n,
                  int V, int sign, float scale, const float2* tw,
                  int nstages, const int* radices, void* stream) {
  return launch_cols(xr, xi, yr, yi, P, n, (long long)V, sign, scale, tw,
                     nstages, radices, stream);
}

// FFT along axis 0 of (n, V) f32 planes, V < 2^31.
int fft_axis0(const float* xr, const float* xi, float* yr, float* yi, int n,
              long long V, int sign, float scale, const float2* tw,
              int nstages, const int* radices, void* stream) {
  if (V > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cols(xr, xi, yr, yi, 1LL, n, V, sign, scale, tw, nstages,
                     radices, stream);
}

// The residency of the fft_cols instance for length n (bf16 != 0: its bf16
// instance): out[5] = {resident blocks an SM, columns a block, threads a
// block, registers a thread, shared bytes a block}.  Returns the CUDA error
// code (cudaErrorInvalidValue for a length with no instance).
int fft_cols_residency(int n, int bf16, int* out) {
  return with_cols_list(n, [&](auto list) {
    return bf16 ? cols_residency_list<__nv_bfloat16>(list, out)
                : cols_residency_list<float>(list, out);
  });
}

}  // extern "C"
