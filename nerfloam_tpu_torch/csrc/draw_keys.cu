// draw_keys: the keys of a Gumbel top-k ray draw in one launch (port of
// the XLA fusion of nerfloam_tpu/ops/sampling.py:23-25, the mask's logits
// plus jax.random.gumbel's -log(-log(u)); no Pallas kernel). From the
// generator's uniform draw u and the points' valid flags:
//   key = (valid ? 0 : -1e9) + (-log(-log(max(u, tiny))))
// one IEEE rounding an operation, in the order of the chain it replaces
// (ops/sampling.draw_keys_plain: clamp, log, neg, log, neg, where, add).
// torch.rand and torch.topk stay around it, so a draw is the generator's
// Philox stream and torch's selection as before.
//
// The logarithm is CUDA's logf, as torch's log kernel calls it (libdevice's
// __nv_logf, whose steps are explicit fused multiply-adds: built with the
// port's -fmad=false or with torch's -fmad=true, its keys read 0 of 2^24
// differing from torch's chain on an H100); chip_smoke's [ray_draw] holds
// the keys torch.equal to the chain on 2^24 uniforms.
//
// One thread an element: 5 B read, 4 B written (0.18 us for 65,536 points
// at 3.35 TB/s). Bound by its launch at the port's sizes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) draw_keys_kernel(const float* __restrict__ u,
                                                             const bool* __restrict__ valid,
                                                             long n, float* __restrict__ keys) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  constexpr float kTiny = 1.17549435e-38f;  // torch.finfo(torch.float32).tiny
  const float x = u[i];
  // clamps as torch.clamp: a NaN stays NaN
  const float noise = -logf(-logf(x < kTiny ? kTiny : x));
  keys[i] = __fadd_rn(valid[i] ? 0.0f : -1e9f, noise);
}

}  // namespace

// u (n,) f32, valid (n,) bool -> keys (n,) f32
extern "C" int nl_draw_keys(const float* u, const bool* valid, long n, float* keys,
                            void* stream) {
  if (n > 0) {
    draw_keys_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(u, valid, n, keys);
  }
  return (int)cudaGetLastError();
}
