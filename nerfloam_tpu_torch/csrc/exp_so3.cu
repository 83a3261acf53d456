// exp_so3: rotation matrices from axis-angle vectors on the card, forward
// and backward, one launch each (ops/se3.py, exp_so3 of a CUDA tensor: every
// pose rotation of BA, the trackers and the map's insert). No TPU kernel is
// behind it: the JAX package's exp_so3 (nerfloam_tpu/ops/se3.py:33-62) is a
// chain of XLA elementwise ops and a 3x3 dot. The kernel takes the place of
// that chain's ~40 eager launches (the sine, the cosine, the product, the
// glue), and rounds the forward as the plain chain does on the CPU
// (csrc/so3.cuh, bit for bit).
//
// Backward: the cotangent G of R = I + A K + B K^2 (K = [w]x) taken back
// through the chain's steps in reverse, as autograd takes the plain chain:
//   gA = sum G K, gB = sum G K^2, gK = A G + (B G) K^T + K^T (B G);
//   w from K's entries; theta^2 through A and B (the exact branch through
//   sin t / t, (1 - cos t) / t^2 and the root, the series below 1e-8);
//   w += 2 w gt2.
// Each step is one IEEE-rounded operation; the sums of a reduction are in
// another order than autograd's, so the backward agrees with the plain
// chain's to rounding (chip_smoke's [exp_so3] states the tolerance), not bit
// for bit.
//
// One thread a rotation: 12 bytes in, 36 out (the backward 48 in, 12 out)
// and ~200 operations; at the port's sizes (one to a few hundred poses) the
// launch is the cost, not bytes or operations.

#include <cuda_runtime.h>

#include "so3.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    exp_so3_fwd_kernel(const float* __restrict__ w, long row_stride, int n,
                       float* __restrict__ R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* v = w + (size_t)i * row_stride;
  float r[9];
  exp_so3(v[0], v[1], v[2], r);
  float* o = R + 9 * (size_t)i;
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = r[k];
}

__global__ void __launch_bounds__(kThreads)
    exp_so3_bwd_kernel(const float* __restrict__ w, long row_stride,
                       const float* __restrict__ G, int n, float* __restrict__ gw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* v = w + (size_t)i * row_stride;
  const float w0 = v[0], w1 = v[1], w2 = v[2];
  const float* g = G + 9 * (size_t)i;
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
  g0 = __fadd_rn(g0, __fmul_rn(__fadd_rn(gt2, gt2), w0));
  g1 = __fadd_rn(g1, __fmul_rn(__fadd_rn(gt2, gt2), w1));
  g2 = __fadd_rn(g2, __fmul_rn(__fadd_rn(gt2, gt2), w2));
  float* o = gw + 3 * (size_t)i;
  o[0] = g0;
  o[1] = g1;
  o[2] = g2;
}

}  // namespace

// w: n rows of 3 f32 at row_stride floats (a pose's [3:6] at stride 6);
// R: (n, 3, 3) f32
extern "C" int nl_exp_so3_fwd(const float* w, long row_stride, int n, float* R, void* stream) {
  if (n > 0) {
    exp_so3_fwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        w, row_stride, n, R);
  }
  return (int)cudaGetLastError();
}

// G: R's cotangent, (n, 3, 3) f32 contiguous; gw: (n, 3) f32
extern "C" int nl_exp_so3_bwd(const float* w, long row_stride, const float* G, int n,
                              float* gw, void* stream) {
  if (n > 0) {
    exp_so3_bwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        w, row_stride, G, n, gw);
  }
  return (int)cudaGetLastError();
}
