// exp_so3, its backward and the 3x3 product as the plain versions round
// them on the CPU (ops/se3.py: exp_so3's chain, _matmul3), shared by
// csrc/lm_step.cu (the GN iteration's tail), csrc/pose_rays.cu (a pose's
// rays and their pose gradient) and csrc/exp_so3.cu (the other rotations
// on the card).
//
// - matmul3: each entry fma(a2, b2, fma(a1, b1, a0 * b0)), as XLA's CPU dot
//   (and torch's CPU product of one matrix) forms it; rotate_row, a row d
//   times R^T, the same chain (se3.rotate_rows).
// - exp_so3: theta^2 summed left to right, the root rounded once, the sine
//   and cosine of native/trig.h (glibc's), one IEEE division each, the
//   series below theta^2 = 1e-8.
// - exp_so3_vjp: the cotangent of w from R's, G, taken back through the
//   chain's steps in reverse, as autograd takes the plain chain:
//     gA = sum G K, gB = sum G K^2, gK = A G + (B G) K^T + K^T (B G);
//     w from K's entries; theta^2 through A and B (the exact branch through
//     sin t / t, (1 - cos t) / t^2 and the root, the series below 1e-8);
//     w += 2 w gt2.
//   Each step is one IEEE-rounded operation; the sums of a reduction run in
//   another order than autograd's, so it agrees with the plain chain's
//   backward to rounding, not bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "ieee.cuh"

// C = A B of row-major 3x3 matrices, each entry fma(a2, b2, fma(a1, b1, a0 b0))
__device__ __forceinline__ void matmul3(const float (&A)[9], const float (&B)[9],
                                        float (&C)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = __fmaf_rn(A[3 * i + 2], B[6 + j],
                               __fmaf_rn(A[3 * i + 1], B[3 + j], __fmul_rn(A[3 * i], B[j])));
    }
  }
}

// se3.exp_so3: R = I + A [w]x + B [w]x^2, A = sin t / t, B = (1 - cos t) / t^2,
// the series below t^2 = 1e-8
__device__ __forceinline__ void exp_so3(float w0, float w1, float w2, float (&R)[9]) {
  const float t2 =
      __fadd_rn(__fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)), __fmul_rn(w2, w2));
  const bool small = t2 < 1e-8f;
  const float safe = small ? 1.0f : t2;
  const float th = __fsqrt_rn(safe);
  const float t4 = __fmul_rn(t2, t2);
  const float a = small ? __fadd_rn(__fsub_rn(1.0f, ieee_div(t2, 6.0f)), ieee_div(t4, 120.0f))
                        : ieee_div(nl_trig::sinf(th), th);
  const float b = small ? __fadd_rn(__fsub_rn(0.5f, ieee_div(t2, 24.0f)), ieee_div(t4, 720.0f))
                        : ieee_div(__fsub_rn(1.0f, nl_trig::cosf(th)), safe);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float K2[9];
  matmul3(K, K, K2);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    R[i] = __fadd_rn(__fadd_rn(eye, __fmul_rn(a, K[i])), __fmul_rn(b, K2[i]));
  }
}

// out = d R^T for one row d: out_i = fma(d2, R_i2, fma(d1, R_i1, d0 * R_i0))
__device__ __forceinline__ void rotate_row(const float* R, float d0, float d1, float d2,
                                           float (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = __fmaf_rn(d2, R[3 * i + 2], __fmaf_rn(d1, R[3 * i + 1], __fmul_rn(d0, R[3 * i])));
  }
}

// gw = (d exp_so3(w) / d w)^T G, G row-major 3x3 (see the header)
__device__ __forceinline__ void exp_so3_vjp(float w0, float w1, float w2, const float* g,
                                            float (&gw)[3]) {
  const float t2 =
      __fadd_rn(__fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)), __fmul_rn(w2, w2));
  const bool small = t2 < 1e-8f;
  const float safe = small ? 1.0f : t2;
  const float th = __fsqrt_rn(safe);
  const float s = nl_trig::sinf(th), c = nl_trig::cosf(th);
  const float a = small ? __fadd_rn(__fsub_rn(1.0f, ieee_div(t2, 6.0f)),
                                    ieee_div(__fmul_rn(t2, t2), 120.0f))
                        : ieee_div(s, th);
  const float b = small ? __fadd_rn(__fsub_rn(0.5f, ieee_div(t2, 24.0f)),
                                    ieee_div(__fmul_rn(t2, t2), 720.0f))
                        : ieee_div(__fsub_rn(1.0f, c), safe);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float K2[9];
  matmul3(K, K, K2);
  float gA = 0.0f, gB = 0.0f, gK[9], gK2[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    gA = __fadd_rn(gA, __fmul_rn(g[k], K[k]));
    gB = __fadd_rn(gB, __fmul_rn(g[k], K2[k]));
    gK[k] = __fmul_rn(g[k], a);
    gK2[k] = __fmul_rn(g[k], b);
  }
  // K2 = K K: dK += gK2 K^T + K^T gK2
  float Kt[9], P[9], Q[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int col = 0; col < 3; ++col) Kt[3 * r + col] = K[3 * col + r];
  }
  matmul3(gK2, Kt, P);
  matmul3(Kt, gK2, Q);
#pragma unroll
  for (int k = 0; k < 9; ++k) gK[k] = __fadd_rn(gK[k], __fadd_rn(P[k], Q[k]));
  // K = [[0, -w2, w1], [w2, 0, -w0], [-w1, w0, 0]]
  float g0 = __fsub_rn(gK[7], gK[5]);
  float g1 = __fsub_rn(gK[2], gK[6]);
  float g2 = __fsub_rn(gK[3], gK[1]);
  float gt2;
  if (small) {  // d/dt2 of 1 - t2/6 + t2^2/120 and 0.5 - t2/24 + t2^2/720
    const float ga4 = ieee_div(gA, 120.0f), gb4 = ieee_div(gB, 720.0f);
    gt2 = __fadd_rn(__fadd_rn(-ieee_div(gA, 6.0f), __fmul_rn(__fadd_rn(ga4, ga4), t2)),
                    __fadd_rn(-ieee_div(gB, 24.0f), __fmul_rn(__fadd_rn(gb4, gb4), t2)));
  } else {
    // A = s / th, s = sin th; B = (1 - c) / safe, c = cos th; th = sqrt(safe)
    const float gs = ieee_div(gA, th);
    float gth = -__fmul_rn(gA, ieee_div(ieee_div(s, th), th));
    gth = __fadd_rn(gth, __fmul_rn(gs, c));
    const float gc = -ieee_div(gB, safe);
    gth = __fadd_rn(gth, -__fmul_rn(gc, s));
    const float gsafe = -__fmul_rn(gB, ieee_div(ieee_div(__fsub_rn(1.0f, c), safe), safe));
    gt2 = __fadd_rn(gsafe, ieee_div(gth, __fmul_rn(2.0f, th)));
  }
  gw[0] = __fadd_rn(g0, __fmul_rn(__fadd_rn(gt2, gt2), w0));
  gw[1] = __fadd_rn(g1, __fmul_rn(__fadd_rn(gt2, gt2), w1));
  gw[2] = __fadd_rn(g2, __fmul_rn(__fadd_rn(gt2, gt2), w2));
}
