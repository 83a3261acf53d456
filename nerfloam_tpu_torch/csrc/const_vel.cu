// const_vel: the deferred warm start in one launch (port of the XLA fusion
// of nerfloam_tpu/core/pipeline.py:60-72, _const_vel_jit; no Pallas
// kernel). From the raw tracked poses of the two frames before, last and
// prev (pose6 = [t, w]):
//   T_l = [exp_so3(w_l) | t_l], T_p = [exp_so3(w_p) | t_p],
//   rel = inv(T_p) T_l, T = T_l rel (full) or [R_l | t of T_l rel] (the
//   translation alone), pose6 = [t of T, log_so3(R of T)].
// Rounded as the plain version (se3.const_vel_plain, what a CPU tensor
// takes) rounds it, bit for bit:
// - exp_so3 as so3.cuh's (glibc's sine and cosine, native/trig.h);
// - inv(T_p)'s translation -(R_p^T t_p) and every entry of the 4 x 4
//   products as XLA's CPU dot (and torch's CPU product of one matrix)
//   forms it, fma(a3, b3, fma(a2, b2, fma(a1, b1, a0 * b0))), over the
//   whole homogeneous matrices, their last rows [0, 0, 0, 1];
// - log_so3 by Shepperd's quaternion as se3.log_so3 takes it: the traces
//   left to right, each root rounded once, IEEE divisions, the first
//   largest trace's branch, its sign made positive, the vector's length
//   in norm3's order (ieee.cuh) and glibc's atan2f (native/trig.h).
// On the card the chain it replaces took two exp_so3 launches, three
// cuBLAS products (which round otherwise) and ~110 elementwise launches of
// log_so3 with one norm3 and one trig.cu atan2.
//
// One thread a pose pair: 48 B read, 24 B written, ~900 operations (the
// path calls it on one pair a frame: a launch's cost).

#include <cuda_runtime.h>

#include "so3.cuh"

namespace {

constexpr int kThreads = 128;

// C = A B of row-major 4 x 4 matrices, each entry the dot's fma chain
__device__ __forceinline__ void matmul4(const float (&A)[16], const float (&B)[16],
                                        float (&C)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = __fmul_rn(A[4 * i], B[j]);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = __fmaf_rn(A[4 * i + k], B[4 * k + j], acc);
      C[4 * i + j] = acc;
    }
  }
}

__device__ __forceinline__ void pose_matrix(const float* p, float (&T)[16]) {
  float R[9];
  exp_so3(p[3], p[4], p[5], R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T[4 * i] = R[3 * i];
    T[4 * i + 1] = R[3 * i + 1];
    T[4 * i + 2] = R[3 * i + 2];
    T[4 * i + 3] = p[i];
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

// se3.log_so3 of the rotation in T's top-left 3 x 3 block
__device__ __forceinline__ void log_so3(const float (&T)[16], float (&w)[3]) {
  const float m00 = T[0], m11 = T[5], m22 = T[10];
  const float r21 = __fsub_rn(T[9], T[6]), r02 = __fsub_rn(T[2], T[8]),
              r10 = __fsub_rn(T[4], T[1]);
  const float s01 = __fadd_rn(T[1], T[4]), s02 = __fadd_rn(T[2], T[8]),
              s12 = __fadd_rn(T[6], T[9]);
  const float tr[4] = {__fadd_rn(__fadd_rn(__fadd_rn(1.0f, m00), m11), m22),
                       __fsub_rn(__fsub_rn(__fadd_rn(1.0f, m00), m11), m22),
                       __fsub_rn(__fadd_rn(__fsub_rn(1.0f, m00), m11), m22),
                       __fadd_rn(__fsub_rn(__fsub_rn(1.0f, m00), m11), m22)};
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // 2 sqrt(clamp(t, 1e-12)), clamped as torch.clamp: a NaN stays NaN
    s[k] = __fmul_rn(2.0f, __fsqrt_rn(tr[k] < 1e-12f ? 1e-12f : tr[k]));
  }
  // torch.argmax: the first largest
  int idx = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (tr[k] > tr[idx]) idx = k;
  }
  float q[4];
  const float sk = s[idx];
  if (idx == 0) {
    q[0] = __fmul_rn(sk, 0.25f);
    q[1] = ieee_div(r21, sk);
    q[2] = ieee_div(r02, sk);
    q[3] = ieee_div(r10, sk);
  } else if (idx == 1) {
    q[0] = ieee_div(r21, sk);
    q[1] = __fmul_rn(sk, 0.25f);
    q[2] = ieee_div(s01, sk);
    q[3] = ieee_div(s02, sk);
  } else if (idx == 2) {
    q[0] = ieee_div(r02, sk);
    q[1] = ieee_div(s01, sk);
    q[2] = __fmul_rn(sk, 0.25f);
    q[3] = ieee_div(s12, sk);
  } else {
    q[0] = ieee_div(r10, sk);
    q[1] = ieee_div(s02, sk);
    q[2] = ieee_div(s12, sk);
    q[3] = __fmul_rn(sk, 0.25f);
  }
  const float sign = q[0] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __fmul_rn(q[k], sign);
  const float n = ieee_norm3(q[1], q[2], q[3]);
  const float theta = __fmul_rn(2.0f, nl_trig::atan2f(n, q[0]));
  const float scale = n < 1e-6f ? 2.0f : ieee_div(theta, n);
  w[0] = __fmul_rn(q[1], scale);
  w[1] = __fmul_rn(q[2], scale);
  w[2] = __fmul_rn(q[3], scale);
}

__global__ void __launch_bounds__(kThreads)
    const_vel_kernel(const float* __restrict__ last, const float* __restrict__ prev, int n,
                     int full, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float Tl[16], Tp[16], Ti[16], rel[16], T[16];
  pose_matrix(last + 6 * (size_t)i, Tl);
  pose_matrix(prev + 6 * (size_t)i, Tp);
  // inv(T_p) = [R_p^T | -(R_p^T t_p)]
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    Ti[4 * r] = Tp[r];
    Ti[4 * r + 1] = Tp[4 + r];
    Ti[4 * r + 2] = Tp[8 + r];
    Ti[4 * r + 3] =
        -__fmaf_rn(Tp[8 + r], Tp[11], __fmaf_rn(Tp[4 + r], Tp[7], __fmul_rn(Tp[r], Tp[3])));
  }
  Ti[12] = 0.0f;
  Ti[13] = 0.0f;
  Ti[14] = 0.0f;
  Ti[15] = 1.0f;
  matmul4(Ti, Tl, rel);
  matmul4(Tl, rel, T);
  if (!full) {  // the rotation stays the last pose's
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      T[4 * r] = Tl[4 * r];
      T[4 * r + 1] = Tl[4 * r + 1];
      T[4 * r + 2] = Tl[4 * r + 2];
    }
  }
  float w[3];
  log_so3(T, w);
  float* o = out + 6 * (size_t)i;
  o[0] = T[3];
  o[1] = T[7];
  o[2] = T[11];
  o[3] = w[0];
  o[4] = w[1];
  o[5] = w[2];
}

}  // namespace

// last, prev (n, 6) f32 pose6 rows; out (n, 6) f32; full: 1 the whole
// motion, 0 the translation alone
extern "C" int nl_const_vel(const float* last, const float* prev, int n, int full, float* out,
                            void* stream) {
  if (n > 0) {
    const_vel_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        last, prev, n, full, out);
  }
  return (int)cudaGetLastError();
}
