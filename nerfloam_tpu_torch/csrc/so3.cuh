// exp_so3 and the 3x3 product as the plain versions round them on the CPU
// (ops/se3.py: exp_so3's chain, _matmul3), shared by csrc/lm_step.cu (the
// GN pose step) and csrc/exp_so3.cu (the eager rotations on the card).
//
// - matmul3: each entry fma(a2, b2, fma(a1, b1, a0 * b0)), as XLA's CPU dot
//   (and torch's CPU product of one matrix) forms it.
// - exp_so3: theta^2 summed left to right, the root rounded once, the sine
//   and cosine of native/trig.h (glibc's), one IEEE division each, the
//   series below theta^2 = 1e-8.

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
