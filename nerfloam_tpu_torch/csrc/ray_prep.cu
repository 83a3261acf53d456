// ray_prep: a tracked frame's (or a BA step's) per-ray setup in one launch
// (port of the XLA fusion of nerfloam_tpu/core/tracking.py:156-160, the
// ray directions, t_cap_for (tracking.py:374-381), the measured depth and
// its gate; the same at core/ba.py's superset; no Pallas kernel). Per ray,
// from its sensor-frame point p and its ground-normal cosine c:
//   n = |p|, dirs = p / (n + 1e-8), t_cap = min(n + T / max(c, 0.05) + 0.5,
//   max_depth), d_meas = n c, depth_ok = 0 < d_meas < max_depth, dnorm = n.
// The length is the norm every site shares (ieee.cuh: jnp.linalg.norm's
// fused chain on the CPU), the divisions IEEE, each step in the plain
// version's order (tracking.ray_prep_plain), so every output equals it bit
// for bit. Where the plain chain takes four norms of the same points and
// a dozen eager ops, this is one pass.
//
// One thread a ray: 16 B read, 25 B written (41 B a ray, 84 KB at 2048
// rays: 0.03 us at 3.35 TB/s), a few dozen operations. Bound by its launch.

#include <cuda_runtime.h>

#include "ieee.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ray_prep_kernel(
    const float* __restrict__ pts, const float* __restrict__ pcos, int n, float trunc,
    float max_depth, float* __restrict__ dirs, float* __restrict__ t_cap,
    float* __restrict__ d_meas, float* __restrict__ dnorm, bool* __restrict__ depth_ok) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = pts[3 * (size_t)i], y = pts[3 * (size_t)i + 1], z = pts[3 * (size_t)i + 2];
  const float c = pcos[i];
  const float d = ieee_norm3(x, y, z);
  const float den = __fadd_rn(d, 1e-8f);
  dirs[3 * (size_t)i] = ieee_div(x, den);
  dirs[3 * (size_t)i + 1] = ieee_div(y, den);
  dirs[3 * (size_t)i + 2] = ieee_div(z, den);
  // clamps as torch.clamp: a NaN stays NaN
  const float band = ieee_div(trunc, c < 0.05f ? 0.05f : c);
  const float cap = __fadd_rn(__fadd_rn(d, band), 0.5f);
  t_cap[i] = cap > max_depth ? max_depth : cap;
  const float dm = __fmul_rn(d, c);
  d_meas[i] = dm;
  dnorm[i] = d;
  depth_ok[i] = dm > 0.0f && dm < max_depth;
}

}  // namespace

// pts (n, 3), pcos (n,) f32; dirs (n, 3), t_cap, d_meas, dnorm (n,) f32,
// depth_ok (n,) bool
extern "C" int nl_ray_prep(const float* pts, const float* pcos, int n, float trunc,
                           float max_depth, float* dirs, float* t_cap, float* d_meas,
                           float* dnorm, bool* depth_ok, void* stream) {
  if (n > 0) {
    ray_prep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        pts, pcos, n, trunc, max_depth, dirs, t_cap, d_meas, dnorm, depth_ok);
  }
  return (int)cudaGetLastError();
}
