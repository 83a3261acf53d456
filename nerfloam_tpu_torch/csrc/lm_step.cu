// lm_step: the GN tracker's pose update after the damped solve, one launch
// a GN iteration (port of nerfloam_tpu/core/tracking.py:326-334, the trust
// region, exp_so3, the composition and log_so3 that XLA fuses into the LM
// loop's body; no Pallas kernel). Per step, from the solve's solution x of
// (H + lam diag H + 1e-6 I) x = b and the pose [t, w]:
//   delta = -x; dt, dth = its halves, each scaled by
//     min(1, r / (|v| + 1e-12)) (r = 0.5 m, 0.1 rad);
//   R_new = exp_so3(dth) exp_so3(w);
//   pose_new = [t + dt, log_so3(R_new)];
// and R_out = exp_so3(w_new), the next iteration's rotation of its ray
// directions (and K11b's), so that no torch op builds it.
//
// Rounding: the plain version is the same chain of torch ops
// (tracking.lm_step_plain), and every step here is one IEEE-rounded
// operation in its order on the CPU: the norms and the division of
// ieee.cuh, theta^2 summed left to right, the cosine in double rounded
// once, the 3x3 products as torch's CPU product (and XLA's) forms them,
// fma(a2, b2, fma(a1, b1, a0 * b0)), log_so3's quaternion branch select by
// the first largest of (tw, tx, ty, tz). sinf and atan2f are CUDA's (within
// 2 ulp) and may round otherwise than the host's sin and atan2; the
// translation has neither and equals the plain version's bit for bit.
//
// Design: one thread a step (the tracker takes one; a batch of steps, one
// thread each, for the checks). The work is a few hundred dependent
// operations on 48 bytes in and 60 out: bound on the H100 by the launch
// and the chain's latency, not by bytes (0.03 ns at 3.35 TB/s) or
// operations. It replaces ~190 eager torch launches a GN iteration (the
// trust region, two exp_so3, a product, log_so3 and its norm, the next
// iteration's exp_so3).

#include <cuda_runtime.h>

#include "ieee.cuh"

namespace {

constexpr int kThreads = 128;

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
                        : ieee_div(sinf(th), th);
  const float b = small ? __fadd_rn(__fsub_rn(0.5f, ieee_div(t2, 24.0f)), ieee_div(t4, 720.0f))
                        : ieee_div(__fsub_rn(1.0f, ieee_cos_f64(th)), safe);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float K2[9];
  matmul3(K, K, K2);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    R[i] = __fadd_rn(__fadd_rn(eye, __fmul_rn(a, K[i])), __fmul_rn(b, K2[i]));
  }
}

__device__ __forceinline__ float two_sqrt(float t) {  // 2 sqrt(max(t, 1e-12))
  return __fmul_rn(2.0f, __fsqrt_rn(t < 1e-12f ? 1e-12f : t));
}

// se3.log_so3 (Shepperd's quaternion extraction): axis-angle of R
__device__ __forceinline__ void log_so3(const float (&R)[9], float (&w)[3]) {
  const float m00 = R[0], m11 = R[4], m22 = R[8];
  const float r21 = __fsub_rn(R[7], R[5]), r02 = __fsub_rn(R[2], R[6]);
  const float r10 = __fsub_rn(R[3], R[1]);
  const float s01 = __fadd_rn(R[1], R[3]), s02 = __fadd_rn(R[2], R[6]);
  const float s12 = __fadd_rn(R[5], R[7]);
  const float tw = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, m00), m11), m22);
  const float tx = __fsub_rn(__fsub_rn(__fadd_rn(1.0f, m00), m11), m22);
  const float ty = __fsub_rn(__fadd_rn(__fsub_rn(1.0f, m00), m11), m22);
  const float tz = __fadd_rn(__fsub_rn(__fsub_rn(1.0f, m00), m11), m22);
  // the first largest of the four, as torch.argmax (and jnp.argmax) pick it
  int idx = 0;
  float best = tw;
  if (tx > best) { idx = 1; best = tx; }
  if (ty > best) { idx = 2; best = ty; }
  if (tz > best) idx = 3;
  float q[4];
  if (idx == 0) {
    const float s = two_sqrt(tw);
    q[0] = __fmul_rn(s, 0.25f); q[1] = ieee_div(r21, s); q[2] = ieee_div(r02, s);
    q[3] = ieee_div(r10, s);
  } else if (idx == 1) {
    const float s = two_sqrt(tx);
    q[0] = ieee_div(r21, s); q[1] = __fmul_rn(s, 0.25f); q[2] = ieee_div(s01, s);
    q[3] = ieee_div(s02, s);
  } else if (idx == 2) {
    const float s = two_sqrt(ty);
    q[0] = ieee_div(r02, s); q[1] = ieee_div(s01, s); q[2] = __fmul_rn(s, 0.25f);
    q[3] = ieee_div(s12, s);
  } else {
    const float s = two_sqrt(tz);
    q[0] = ieee_div(r10, s); q[1] = ieee_div(s02, s); q[2] = ieee_div(s12, s);
    q[3] = __fmul_rn(s, 0.25f);
  }
  const float sign = q[0] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __fmul_rn(q[k], sign);
  const float n = ieee_norm3(q[1], q[2], q[3]);
  const float theta = __fmul_rn(2.0f, atan2f(n, q[0]));
  const bool small = n < 1e-6f;
  const float scale = small ? 2.0f : ieee_div(theta, n);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = __fmul_rn(q[k + 1], scale);
}

// v *= min(1, r / (|v| + 1e-12)); NaN stays NaN, as torch.clamp leaves it
__device__ __forceinline__ void clip(float (&v)[3], float r) {
  float s = ieee_div(r, __fadd_rn(ieee_norm3(v[0], v[1], v[2]), 1e-12f));
  s = s > 1.0f ? 1.0f : s;
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = __fmul_rn(v[k], s);
}

__global__ void __launch_bounds__(kThreads) lm_step_kernel(const float* __restrict__ step,
                                                           const float* __restrict__ pose, int n,
                                                           float* __restrict__ out_pose,
                                                           float* __restrict__ out_R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* x = step + 6 * (size_t)i;
  const float* p = pose + 6 * (size_t)i;
  float dt[3] = {-x[0], -x[1], -x[2]};
  float dth[3] = {-x[3], -x[4], -x[5]};
  clip(dt, 0.5f);
  clip(dth, 0.1f);
  float Rd[9], Rp[9], Rn[9];
  exp_so3(dth[0], dth[1], dth[2], Rd);
  exp_so3(p[3], p[4], p[5], Rp);
  matmul3(Rd, Rp, Rn);
  float w[3];
  log_so3(Rn, w);
  float* o = out_pose + 6 * (size_t)i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __fadd_rn(p[k], dt[k]);
    o[k + 3] = w[k];
  }
  float R[9];
  exp_so3(w[0], w[1], w[2], R);
  float* r = out_R + 9 * (size_t)i;
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = R[k];
}

}  // namespace

// step, pose: (n, 6) f32, the solve's solutions and the poses; out_pose (n, 6),
// out_R (n, 3, 3)
extern "C" int nl_lm_step(const float* step, const float* pose, int n, float* out_pose,
                          float* out_R, void* stream) {
  if (n > 0) {
    lm_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        step, pose, n, out_pose, out_R);
  }
  return (int)cudaGetLastError();
}
