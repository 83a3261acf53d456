// lm_step.cu: the GN tracker's iteration tail in one launch (lm_tail), and
// the pose step alone (lm_step). Port of nerfloam_tpu/core/tracking.py:
// 326-334 and the next iteration's se3.rotate_dirs (:249): the damped solve,
// the trust region, exp_so3, the composition and log_so3 that XLA fuses
// into the LM loop's body, then the rays' rotation at the new pose; no
// Pallas kernel.
//
// lm_tail, from the normal equations H (6x6), b, the damping lam, the pose
// [t, w] and the frame's ray directions:
//   Hd = H with diagonal (H_ii + lam H_ii) + 1e-6 (the order jitted XLA
//     forms H + lam diag(diag H) + 1e-6 I in), the rest H_ij;
//   x = Hd^-1 b by LU with partial pivoting (the pivot the first largest
//     |a| of its column, as LAPACK's isamax picks it; each multiplier one
//     IEEE division; right-looking rank-1 updates, a rounded product and a
//     rounded difference each, as reference LAPACK's sgetf2 and sger
//     uncontracted; b eliminated with the rows; back substitution column
//     by column, from the last);
//   delta = -x; dt, dth its halves, each scaled by
//     min(1, r / (|v| + 1e-12)) (r = 0.5 m, 0.1 rad);
//   R_new = exp_so3(dth) exp_so3(w); pose_new = [t + dt, log_so3(R_new)];
//   R_out = exp_so3(w_new), and each ray's wdirs = d R_out^T, each entry
//     fma(d2, R_i2, fma(d1, R_i1, d0 * R_i0)) (se3.rotate_rows).
// lm_step is the same from x on, without the rays (a batch of steps, one
// thread each: the checks' form).
//
// Rounding: the plain versions are the same chains of torch ops
// (tracking.lm_tail_plain, tracking.lm_step_plain), and every step here is
// one IEEE-rounded operation in their order: the norms and the division of
// ieee.cuh, theta^2 summed left to right, the sine, cosine and atan2 of
// native/trig.h (glibc's, as the plain version's ops/trig), the 3x3
// products as torch's CPU product (and XLA's) forms them, log_so3's
// quaternion branch select by the first largest of (tw, tx, ty, tz). The
// solve reproduces neither LAPACK's f32 rounding under jnp.linalg.solve
// nor MKL's under torch.linalg.solve, the port's solve before
// (tests/test_torch_gn_tail.py compares the three).
//
// Design: a GN iteration's tail is ~1,500 dependent operations on 168
// bytes, then 2048 rays of 12 bytes in and 12 out: bound on the H100 by
// the launch and the chain's latency (its bytes take ~0.015 us at
// 3.35 TB/s). Each block solves the system and takes the step on one
// thread, redundantly, puts R in shared memory and rotates its slice of
// the rays; block 0 writes the pose and R. No grid sync, no second launch,
// and no eager op between K3 and the next iteration's rays: it replaces
// the damping's ~4 launches, cuSOLVER's factor and solve with their
// copies, the step's launch and cuBLAS's product. A batch of systems (the
// checks') takes a grid row each.

#include <cuda_runtime.h>

#include "ieee.cuh"
#include "so3.cuh"

namespace {

constexpr int kThreads = 128;

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
  const float theta = __fmul_rn(2.0f, nl_trig::atan2f(n, q[0]));
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

// the pose step from the solve's solution x (delta = -x) and the pose p:
// the new pose and R = exp_so3 of its rotation
__device__ __forceinline__ void lm_step_dev(const float (&x)[6], const float* p,
                                            float (&pose)[6], float (&R)[9]) {
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
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pose[k] = __fadd_rn(p[k], dt[k]);
    pose[k + 3] = w[k];
  }
  exp_so3(w[0], w[1], w[2], R);
}

// x = (H + lam diag H + 1e-6 I)^-1 b (see the header)
__device__ __forceinline__ void damped_solve(const float* H, const float* bv, float lam,
                                             float (&x)[6]) {
  float A[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = H[6 * i + j];
    A[i][i] = __fadd_rn(__fadd_rn(A[i][i], __fmul_rn(A[i][i], lam)), 1e-6f);
    x[i] = bv[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
    // swap rows k and p (selects, so that the arrays stay in registers)
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = x[k];
        x[k] = x[i];
        x[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = ieee_div(A[i][k], A[k][k]);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = __fsub_rn(A[i][j], __fmul_rn(l, A[k][j]));
      x[i] = __fsub_rn(x[i], __fmul_rn(l, x[k]));
    }
  }
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    x[j] = ieee_div(x[j], A[j][j]);
#pragma unroll
    for (int i = 0; i < j; ++i) x[i] = __fsub_rn(x[i], __fmul_rn(A[i][j], x[j]));
  }
}

__global__ void __launch_bounds__(kThreads) lm_step_kernel(const float* __restrict__ step,
                                                           const float* __restrict__ pose, int n,
                                                           float* __restrict__ out_pose,
                                                           float* __restrict__ out_R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* s = step + 6 * (size_t)i;
  const float x[6] = {s[0], s[1], s[2], s[3], s[4], s[5]};
  float pn[6], R[9];
  lm_step_dev(x, pose + 6 * (size_t)i, pn, R);
  float* o = out_pose + 6 * (size_t)i;
  float* r = out_R + 9 * (size_t)i;
#pragma unroll
  for (int k = 0; k < 6; ++k) o[k] = pn[k];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = R[k];
}

constexpr int kTailThreads = 256;

// grid (ceil(n_rays / 256), systems): each block solves its system, takes
// the step and rotates its slice of the system's rays
__global__ void __launch_bounds__(kTailThreads)
    lm_tail_kernel(const float* __restrict__ H, const float* __restrict__ b, float lam,
                   const float* __restrict__ pose, const float* __restrict__ dirs, int n_rays,
                   float* __restrict__ out_pose, float* __restrict__ out_R,
                   float* __restrict__ out_wdirs) {
  __shared__ float sR[9];
  const size_t sys = blockIdx.y;
  if (threadIdx.x == 0) {
    float x[6], pn[6], R[9];
    damped_solve(H + 36 * sys, b + 6 * sys, lam, x);
    lm_step_dev(x, pose + 6 * sys, pn, R);
#pragma unroll
    for (int k = 0; k < 9; ++k) sR[k] = R[k];
    if (blockIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) out_pose[6 * sys + k] = pn[k];
#pragma unroll
      for (int k = 0; k < 9; ++k) out_R[9 * sys + k] = R[k];
    }
  }
  __syncthreads();
  const int r = blockIdx.x * kTailThreads + threadIdx.x;
  if (r >= n_rays) return;
  const size_t row = sys * n_rays + r;
  const float* d = dirs + 3 * row;
  float o[3];
  rotate_row(sR, d[0], d[1], d[2], o);
  float* w = out_wdirs + 3 * row;
  w[0] = o[0];
  w[1] = o[1];
  w[2] = o[2];
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

// H (n, 6, 6), b (n, 6), pose (n, 6), dirs (n, n_rays, 3) f32; out_pose (n, 6),
// out_R (n, 3, 3), out_wdirs (n, n_rays, 3); lam the damping
extern "C" int nl_lm_tail(const float* H, const float* b, float lam, const float* pose,
                          const float* dirs, int n_rays, int n, float* out_pose, float* out_R,
                          float* out_wdirs, void* stream) {
  if (n > 0) {
    const dim3 grid(n_rays > 0 ? (n_rays + kTailThreads - 1) / kTailThreads : 1, n);
    lm_tail_kernel<<<grid, kTailThreads, 0, (cudaStream_t)stream>>>(
        H, b, lam, pose, dirs, n_rays, out_pose, out_R, out_wdirs);
  }
  return (int)cudaGetLastError();
}
