// The straight-line butterflies of the register-resident kernels: the
// radix-8, radix-16 and radix-32 DFTs and their twiddle rotations (cos/sin
// of multiples of pi/16 from float64), in the arithmetic type F of the
// instance: float, or double for the f64 instances, whose constants are
// then the float64 values themselves (F(x) of a double literal rounds to
// the same float as the f32 literal did).  Included by stockham.cu
// (fft_fused2_kernel, fft_fused2_regs_kernel, fft_last_kernel) and cols.cu
// (fft_cols_kernel), after stockham_tile.cuh, whose Dft<R> template they
// specialise; internal linkage, as there.

#pragma once

#include "stockham_tile.cuh"

namespace {

// v *= exp(s * 2*pi*i * E/8).
template <int E, typename F>
__device__ __forceinline__ void rot8(F& re, F& im, F s) {
  constexpr int e = E & 7;
  if constexpr (e == 0) {
    return;
  } else if constexpr (e == 4) {
    re = -re;
    im = -im;
  } else if constexpr (e == 2 || e == 6) {
    const F q = e == 2 ? s : -s;   // times q*i
    const F t = re;
    re = -q * im;
    im = q * t;
  } else {
    constexpr F h = F(0.7071067811865476);   // cos(pi/4), float64
    constexpr F c = (e == 1 || e == 7) ? h : -h;
    constexpr F sn = (e == 1 || e == 3) ? h : -h;
    const F ss = s * sn, t = re;
    re = fmac(t, c, -im * ss);
    im = fmac(t, ss, im * c);
  }
}

// In-register 8-point DFT, y[k] = sum_r v[r] exp(s*2*pi*i*r*k/8), as two
// 4-point DFTs of the even and odd inputs joined by W_8^k.
template <>
struct Dft<8> {
  template <typename F>
  __device__ __forceinline__ static void run(F* vr, F* vi, F s) {
    F er[4], ei[4], orr[4], oi[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      er[b] = vr[2 * b];
      ei[b] = vi[2 * b];
      orr[b] = vr[2 * b + 1];
      oi[b] = vi[2 * b + 1];
    }
    Dft<4>::run(er, ei, s);
    Dft<4>::run(orr, oi, s);
    rot8<1>(orr[1], oi[1], s);
    rot8<2>(orr[2], oi[2], s);
    rot8<3>(orr[3], oi[3], s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vr[k] = er[k] + orr[k];
      vi[k] = ei[k] + oi[k];
      vr[k + 4] = er[k] - orr[k];
      vi[k + 4] = ei[k] - oi[k];
    }
  }
};

// v *= exp(s * 2*pi*i * E/16).
template <int E, typename F>
__device__ __forceinline__ void rot16(F& re, F& im, F s) {
  constexpr int e = E & 15;
  if constexpr (e % 2 == 0) {
    rot8<e / 2>(re, im, s);
  } else {
    constexpr F c1 = F(0.9238795325112867);   // cos(pi/8), float64
    constexpr F s1 = F(0.3826834323650898);   // sin(pi/8)
    constexpr F c = (e == 1 || e == 15) ? c1
                        : (e == 3 || e == 13) ? s1
                        : (e == 5 || e == 11) ? -s1 : -c1;
    constexpr F sn = (e == 1 || e == 7) ? s1
                     : (e == 3 || e == 5) ? c1
                     : (e == 9 || e == 15) ? -s1 : -c1;
    const F ss = s * sn, t = re;
    re = fmac(t, c, -im * ss);
    im = fmac(t, ss, im * c);
  }
}

// In-register 16-point DFT, y[k] = sum_r v[r] exp(s*2*pi*i*r*k/16): with
// r = 4a + b and k = k1 + 4*k2, a 4-point DFT over a for each b, the
// rotation W16^(b*k1), then a 4-point DFT over b for each k1.
template <>
struct Dft<16> {
  template <typename F>
  __device__ __forceinline__ static void run(F* vr, F* vi, F s) {
    F ur[4][4], ui[4][4];   // [k1][b]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      F tr[4], ti[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        tr[a] = vr[4 * a + b];
        ti[a] = vi[4 * a + b];
      }
      Dft<4>::run(tr, ti, s);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) {
        ur[k1][b] = tr[k1];
        ui[k1][b] = ti[k1];
      }
    }
    rot16<1>(ur[1][1], ui[1][1], s);
    rot16<2>(ur[1][2], ui[1][2], s);
    rot16<3>(ur[1][3], ui[1][3], s);
    rot16<2>(ur[2][1], ui[2][1], s);
    rot16<4>(ur[2][2], ui[2][2], s);
    rot16<6>(ur[2][3], ui[2][3], s);
    rot16<3>(ur[3][1], ui[3][1], s);
    rot16<6>(ur[3][2], ui[3][2], s);
    rot16<9>(ur[3][3], ui[3][3], s);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      Dft<4>::run(ur[k1], ui[k1], s);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        vr[k1 + 4 * k2] = ur[k1][k2];
        vi[k1 + 4 * k2] = ui[k1][k2];
      }
    }
  }
};

// cos(2*pi*e/32) in float64, correctly rounded (the first quadrant's nine
// values, then their symmetries, so the quarter turns are exact).
__host__ __device__ constexpr double cos32(int e) {
  constexpr double q[9] = {1.0, 0.9807852804032304, 0.9238795325112867,
                           0.8314696123025452, 0.7071067811865476,
                           0.5555702330196022, 0.3826834323650898,
                           0.19509032201612828, 0.0};
  e &= 31;
  return e <= 8 ? q[e] : e <= 16 ? -q[16 - e] : e <= 24 ? -q[e - 16]
                                                        : q[32 - e];
}

// v *= exp(s * 2*pi*i * E/32).
template <int E, typename F>
__device__ __forceinline__ void rot32(F& re, F& im, F s) {
  constexpr int e = E & 31;
  if constexpr (e % 2 == 0) {
    rot16<e / 2>(re, im, s);
  } else {
    constexpr F c = F(cos32(e)), sn = F(cos32(e - 8));
    const F ss = s * sn, t = re;
    re = fmac(t, c, -im * ss);
    im = fmac(t, ss, im * c);
  }
}

// The rotations W32^(b*k1) of Dft<32>'s middle step, b = 1..3, k1 = 1..7.
template <int B, int K1, typename F>
__device__ __forceinline__ void rot32_grid(F (&ur)[8][4], F (&ui)[8][4],
                                           F s) {
  rot32<B * K1>(ur[K1][B], ui[K1][B], s);
  if constexpr (K1 < 7) {
    rot32_grid<B, K1 + 1>(ur, ui, s);
  } else if constexpr (B < 3) {
    rot32_grid<B + 1, 1>(ur, ui, s);
  }
}

// In-register 32-point DFT, y[k] = sum_r v[r] exp(s*2*pi*i*r*k/32): with
// r = 4a + b and k = k1 + 8*k2, an 8-point DFT over a for each b, the
// rotation W32^(b*k1), then a 4-point DFT over b for each k1.
template <>
struct Dft<32> {
  template <typename F>
  __device__ __forceinline__ static void run(F* vr, F* vi, F s) {
    F ur[8][4], ui[8][4];   // [k1][b]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      F tr[8], ti[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        tr[a] = vr[4 * a + b];
        ti[a] = vi[4 * a + b];
      }
      Dft<8>::run(tr, ti, s);
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) {
        ur[k1][b] = tr[k1];
        ui[k1][b] = ti[k1];
      }
    }
    rot32_grid<1, 1>(ur, ui, s);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      Dft<4>::run(ur[k1], ui[k1], s);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        vr[k1 + 8 * k2] = ur[k1][k2];
        vi[k1 + 8 * k2] = ui[k1][k2];
      }
    }
  }
};

}  // namespace
