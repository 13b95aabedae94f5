// The straight-line butterflies of the register-resident kernels: the
// radix-8 and radix-16 DFTs and their twiddle rotations (cos/sin of pi/4
// and pi/8 from float64).  Included by stockham.cu (fft_fused2_kernel,
// fft_last_kernel) and cols.cu (fft_cols_kernel), after stockham_tile.cuh,
// whose Dft<R> template they specialise; internal linkage, as there.

#pragma once

#include "stockham_tile.cuh"

namespace {

// v *= exp(s * 2*pi*i * E/8).
template <int E>
__device__ __forceinline__ void rot8(float& re, float& im, float s) {
  constexpr int e = E & 7;
  if constexpr (e == 0) {
    return;
  } else if constexpr (e == 4) {
    re = -re;
    im = -im;
  } else if constexpr (e == 2 || e == 6) {
    const float q = e == 2 ? s : -s;   // times q*i
    const float t = re;
    re = -q * im;
    im = q * t;
  } else {
    constexpr float h = 0.7071067811865476f;   // cos(pi/4), from float64
    constexpr float c = (e == 1 || e == 7) ? h : -h;
    constexpr float sn = (e == 1 || e == 3) ? h : -h;
    const float ss = s * sn, t = re;
    re = fmaf(t, c, -im * ss);
    im = fmaf(t, ss, im * c);
  }
}

// In-register 8-point DFT, y[k] = sum_r v[r] exp(s*2*pi*i*r*k/8), as two
// 4-point DFTs of the even and odd inputs joined by W_8^k.
template <>
struct Dft<8> {
  __device__ __forceinline__ static void run(float* vr, float* vi, float s) {
    float er[4], ei[4], orr[4], oi[4];
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
template <int E>
__device__ __forceinline__ void rot16(float& re, float& im, float s) {
  constexpr int e = E & 15;
  if constexpr (e % 2 == 0) {
    rot8<e / 2>(re, im, s);
  } else {
    constexpr float c1 = 0.9238795325112867f;   // cos(pi/8), from float64
    constexpr float s1 = 0.3826834323650898f;   // sin(pi/8)
    constexpr float c = (e == 1 || e == 15) ? c1
                        : (e == 3 || e == 13) ? s1
                        : (e == 5 || e == 11) ? -s1 : -c1;
    constexpr float sn = (e == 1 || e == 7) ? s1
                         : (e == 3 || e == 5) ? c1
                         : (e == 9 || e == 15) ? -s1 : -c1;
    const float ss = s * sn, t = re;
    re = fmaf(t, c, -im * ss);
    im = fmaf(t, ss, im * c);
  }
}

// In-register 16-point DFT, y[k] = sum_r v[r] exp(s*2*pi*i*r*k/16): with
// r = 4a + b and k = k1 + 4*k2, a 4-point DFT over a for each b, the
// rotation W16^(b*k1), then a 4-point DFT over b for each k1.
template <>
struct Dft<16> {
  __device__ __forceinline__ static void run(float* vr, float* vi, float s) {
    float ur[4][4], ui[4][4];   // [k1][b]
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float tr[4], ti[4];
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

}  // namespace
