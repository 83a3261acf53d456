// The rounding the port keeps, in one place for every kernel that needs it:
// the JAX package's arithmetic as XLA's CPU backend rounds it (the plain
// torch versions in nerfloam_tpu_torch/ops/ieee.py and ops/se3.py round
// the same way on both devices).
//
// - ieee_norm3 / ieee_norm2: jnp.linalg.norm over a last axis of 3 (2): XLA
//   contracts the sum of squares into fused multiply-adds in index order,
//   sqrt(fma(z, z, fma(y, y, x * x))) (sqrt(fma(y, y, x * x))).
// - ieee_div: one IEEE division (JAX divides once where torch may take a
//   reciprocal and a product).
// - ieee_cos_f64: exp_so3's cosine, taken in double and rounded once to
//   float, as the correctly rounded cosine of XLA's CPU backend at the
//   angles of a pose step.
//
// Every step is an _rn intrinsic, so the result does not depend on
// -fmad (the library is built with -fmad=false: no product is contracted
// unless written as an fma here).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float ieee_norm3(float x, float y, float z) {
  return __fsqrt_rn(__fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
}

__device__ __forceinline__ float ieee_norm2(float x, float y) {
  return __fsqrt_rn(__fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float ieee_div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float ieee_cos_f64(float t) {
  return __double2float_rn(cos((double)t));
}
