// norm3: the length of (n, 3) f32 vectors, |x| = sqrt(x0^2 + x1^2 + x2^2),
// rounded as the JAX package's jnp.linalg.norm(x, axis=-1) on the CPU.
// It replaces the XLA reduce fusion that jnp.linalg.norm lowers to
// (multiply, reduce-add over the last axis, sqrt); the JAX package has no
// Pallas kernel for it. Its sites: ray directions and measured depths in
// the trackers and BA, t_cap, the LM trust region, the log map's angle,
// the support voxels' directions and the motion direction of
// ba_pose_project=along.
//
// Rounding: XLA's CPU backend contracts the reduction into fused
// multiply-adds in index order, sqrt(fma(x2, x2, fma(x1, x1, x0 * x0))),
// and so does this kernel, step by step with the _rn intrinsics
// (ieee_norm3 in ieee.cuh, the chain every kernel of the port shares).
// torch.linalg.norm on CUDA reduces in another order and differs from the
// CPU on ~14% of random rows.
//
// One thread a row: its 12 bytes read, 4 written; a warp reads 384
// contiguous bytes. Bound on the H100: 16 B a row over 3.35 TB/s, e.g.
// 0.31 us for 65,536 rows; at such sizes a launch's start and end cost
// more than its bytes.

#include <cuda_runtime.h>

#include "ieee.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) norm3_kernel(const float* __restrict__ x, int n,
                                                         float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* p = x + 3 * (size_t)i;
  out[i] = ieee_norm3(p[0], p[1], p[2]);
}

}  // namespace

extern "C" int nl_norm3(const float* x, int n, float* out, void* stream) {
  if (n > 0) {
    norm3_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(x, n,
                                                                                      out);
  }
  return (int)cudaGetLastError();
}
