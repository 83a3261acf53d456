// exp_so3: rotation matrices from axis-angle vectors on the card, forward
// and backward, one launch each (ops/se3.py, exp_so3 of a CUDA tensor: the
// rotations that csrc/pose_rays.cu and csrc/lm_step.cu do not fold in: the
// map's insert, the scan-to-scan range image and system, the bias probe,
// the pipeline's pose matrices). No TPU kernel is behind it: the JAX package's exp_so3
// (nerfloam_tpu/ops/se3.py:33-62) is a chain of XLA elementwise ops and a
// 3x3 dot. The kernel takes the place of that chain's ~40 eager launches
// (the sine, the cosine, the product, the glue), and rounds the forward as
// the plain chain does on the CPU (csrc/so3.cuh, bit for bit); the backward
// is so3.cuh's exp_so3_vjp, which agrees with the plain chain's autograd to
// rounding (chip_smoke's [exp_so3] states the tolerance), not bit for bit.
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
  float o[3];
  exp_so3_vjp(v[0], v[1], v[2], G + 9 * (size_t)i, o);
  float* out = gw + 3 * (size_t)i;
  out[0] = o[0];
  out[1] = o[1];
  out[2] = o[2];
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
