// ray_prep: a ray draw on the card, from the indices a draw picked to every
// per-ray input of the tracker's and BA's iterations (port of the XLA
// fusions of nerfloam_tpu/core/tracking.py:150-163, the gathers, the ray
// directions, t_cap_for (tracking.py:374-381), the measured depth, its gate
// and the band target; the same at core/ba.py's superset, its per-iteration
// pick and its draw without one; no Pallas kernel). Per ray, from its
// sensor-frame point p and its ground-normal cosine c:
//   n = |p|, dirs = p / (n + 1e-8), t_cap = min(n + T / max(c, 0.05) + 0.5,
//   max_depth), d_meas = n c, depth_ok = 0 < d_meas < max_depth, dnorm = n,
//   bias_ray = c < 0.999 ? sdf_bias[0] : sdf_bias[1] (0 without one).
// The length is the norm every site shares (ieee.cuh: jnp.linalg.norm's
// fused chain on the CPU), the divisions IEEE, each step in the plain
// version's order (tracking.ray_prep_plain), so every output equals it bit
// for bit.
//
// Four kernels, one launch each:
// - ray_draw_kernel (tracking.ray_draw): a draw's top-k indices (W, n) ->
//   the rank's columns [c0, c0 + nl) of each row gathered (points, cosines,
//   valid, ANDed with the frame's flag for BA) and set up, written as the
//   plain chain's separate arrays;
// - ray_superset_kernel (tracking.ray_superset): BA's superset, each ray
//   one 32 B row [dir xyz, p xyz, cos, |p|] (two float4 stores), the
//   directions again as (W, K, 3) for se3.pose_rays, t_cap and valid;
// - ray_pick_kernel (tracking.ray_pick): a BA iteration's randint picks
//   (W, N) from that superset, each ray one 32 B sector read (where the
//   chain gathered four arrays), written in the rows BA's render reads,
//   with each ray's superset row (w K + idx, int32) for the grid sampler;
// - ray_prep_kernel (tracking.ray_prep): the setup alone of points handed
//   in (the tp BA iteration's).
//
// One thread a ray: 16-32 B read, 25-45 B written (~80 KB at 2048 rays:
// 0.03 us at 3.35 TB/s), a few dozen operations. Bound by its launch.

#include <cuda_runtime.h>

#include "ieee.cuh"

namespace {

constexpr int kThreads = 256;

// the setup of one ray from its point and cosine (see the header)
struct Prepped {
  float dx, dy, dz, t_cap, d_meas, d;
  bool ok;
};

__device__ __forceinline__ Prepped prep(float x, float y, float z, float c, float trunc,
                                        float max_depth) {
  Prepped r;
  r.d = ieee_norm3(x, y, z);
  const float den = __fadd_rn(r.d, 1e-8f);
  r.dx = ieee_div(x, den);
  r.dy = ieee_div(y, den);
  r.dz = ieee_div(z, den);
  // clamps as torch.clamp: a NaN stays NaN
  const float band = ieee_div(trunc, c < 0.05f ? 0.05f : c);
  const float cap = __fadd_rn(__fadd_rn(r.d, band), 0.5f);
  r.t_cap = cap > max_depth ? max_depth : cap;
  r.d_meas = __fmul_rn(r.d, c);
  r.ok = r.d_meas > 0.0f && r.d_meas < max_depth;
  return r;
}

__global__ void __launch_bounds__(kThreads) ray_prep_kernel(
    const float* __restrict__ pts, const float* __restrict__ pcos, int n, float trunc,
    float max_depth, float* __restrict__ dirs, float* __restrict__ t_cap,
    float* __restrict__ d_meas, float* __restrict__ dnorm, bool* __restrict__ depth_ok) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Prepped r = prep(pts[3 * (size_t)i], pts[3 * (size_t)i + 1], pts[3 * (size_t)i + 2],
                         pcos[i], trunc, max_depth);
  dirs[3 * (size_t)i] = r.dx;
  dirs[3 * (size_t)i + 1] = r.dy;
  dirs[3 * (size_t)i + 2] = r.dz;
  t_cap[i] = r.t_cap;
  d_meas[i] = r.d_meas;
  dnorm[i] = r.d;
  depth_ok[i] = r.ok;
}

// outputs of ray_draw_kernel, (W, nl) each; f32 arrays in one buffer
struct DrawOut {
  float *pts, *pcos, *dirs, *t_cap, *d_meas, *dnorm, *bias_ray;
  bool *rvalid, *depth_ok;
};

__global__ void __launch_bounds__(kThreads) ray_draw_kernel(
    const long long* __restrict__ idx, int n_all, int c0, int nl, int W, long P,
    const float* __restrict__ points, const float* __restrict__ cos,
    const bool* __restrict__ valid, const bool* __restrict__ active,
    const float* __restrict__ bias, float trunc, float max_depth, DrawOut o) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= W * nl) return;
  const int w = i / nl;
  const size_t s = (size_t)w * P + (size_t)idx[(size_t)w * n_all + c0 + (i - w * nl)];
  const float x = points[3 * s], y = points[3 * s + 1], z = points[3 * s + 2], c = cos[s];
  const Prepped r = prep(x, y, z, c, trunc, max_depth);
  o.pts[3 * (size_t)i] = x;
  o.pts[3 * (size_t)i + 1] = y;
  o.pts[3 * (size_t)i + 2] = z;
  o.pcos[i] = c;
  o.rvalid[i] = valid[s] && (active == nullptr || active[w]);
  o.dirs[3 * (size_t)i] = r.dx;
  o.dirs[3 * (size_t)i + 1] = r.dy;
  o.dirs[3 * (size_t)i + 2] = r.dz;
  o.t_cap[i] = r.t_cap;
  o.d_meas[i] = r.d_meas;
  o.depth_ok[i] = r.ok;
  o.dnorm[i] = r.d;
  o.bias_ray[i] = bias == nullptr ? 0.0f : (c < 0.999f ? bias[0] : bias[1]);
}

__global__ void __launch_bounds__(kThreads) ray_superset_kernel(
    const long long* __restrict__ idx, int K, int W, long P, const float* __restrict__ points,
    const float* __restrict__ cos, const bool* __restrict__ valid, float trunc,
    float max_depth, float4* __restrict__ rows, float* __restrict__ dirs,
    float* __restrict__ t_cap, bool* __restrict__ svalid) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= W * K) return;
  const int w = i / K;
  const size_t s = (size_t)w * P + (size_t)idx[i];
  const float x = points[3 * s], y = points[3 * s + 1], z = points[3 * s + 2], c = cos[s];
  const Prepped r = prep(x, y, z, c, trunc, max_depth);
  rows[2 * (size_t)i] = make_float4(r.dx, r.dy, r.dz, x);
  rows[2 * (size_t)i + 1] = make_float4(y, z, c, r.d);
  dirs[3 * (size_t)i] = r.dx;
  dirs[3 * (size_t)i + 1] = r.dy;
  dirs[3 * (size_t)i + 2] = r.dz;
  t_cap[i] = r.t_cap;
  svalid[i] = valid[s];
}

__global__ void __launch_bounds__(kThreads) ray_pick_kernel(
    const long long* __restrict__ ridx, int N, int c0, int nl, int W, int K,
    const float4* __restrict__ rows, const bool* __restrict__ svalid,
    const bool* __restrict__ active, bool* __restrict__ rvalid, float* __restrict__ pts,
    float* __restrict__ pcos, float* __restrict__ dirs, float* __restrict__ dnorm,
    int* __restrict__ srow) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= W * nl) return;
  const int w = i / nl;
  const int row = w * K + (int)ridx[(size_t)w * N + c0 + (i - w * nl)];
  const float4 a = rows[2 * (size_t)row], b = rows[2 * (size_t)row + 1];
  rvalid[i] = svalid[row] && active[w];
  pts[3 * (size_t)i] = a.w;
  pts[3 * (size_t)i + 1] = b.x;
  pts[3 * (size_t)i + 2] = b.y;
  pcos[i] = b.z;
  dirs[3 * (size_t)i] = a.x;
  dirs[3 * (size_t)i + 1] = a.y;
  dirs[3 * (size_t)i + 2] = a.z;
  dnorm[i] = b.w;
  srow[i] = row;
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

// idx (W, n_all) int64 (a draw's top-k); the columns [c0, c0 + nl) of each
// row; points (W, P, 3), cos (W, P) f32, valid (W, P) bool; active (W,) bool
// or null (all); bias (2,) f32 or null (0). Outputs (W, nl[, 3]) each
extern "C" int nl_ray_draw(const long long* idx, int n_all, int c0, int nl, int W, long P,
                           const float* points, const float* cos, const bool* valid,
                           const bool* active, const float* bias, float trunc, float max_depth,
                           float* pts, float* pcos, float* dirs, float* t_cap, float* d_meas,
                           float* dnorm, float* bias_ray, bool* rvalid, bool* depth_ok,
                           void* stream) {
  const int n = W * nl;
  if (n > 0) {
    const DrawOut o{pts, pcos, dirs, t_cap, d_meas, dnorm, bias_ray, rvalid, depth_ok};
    ray_draw_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        idx, n_all, c0, nl, W, P, points, cos, valid, active, bias, trunc, max_depth, o);
  }
  return (int)cudaGetLastError();
}

// idx (W, K) int64; rows (W, K, 8) f32, 16 B aligned; dirs (W, K, 3),
// t_cap (W, K) f32; svalid (W, K) bool
extern "C" int nl_ray_superset(const long long* idx, int K, int W, long P, const float* points,
                               const float* cos, const bool* valid, float trunc,
                               float max_depth, float* rows, float* dirs, float* t_cap,
                               bool* svalid, void* stream) {
  const int n = W * K;
  if (n > 0) {
    ray_superset_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        idx, K, W, P, points, cos, valid, trunc, max_depth, (float4*)rows, dirs, t_cap, svalid);
  }
  return (int)cudaGetLastError();
}

// ridx (W, N) int64 in [0, K); the columns [c0, c0 + nl); rows, svalid
// from nl_ray_superset; active (W,) bool. Outputs (W * nl[, 3]) each
extern "C" int nl_ray_pick(const long long* ridx, int N, int c0, int nl, int W, int K,
                           const float* rows, const bool* svalid, const bool* active,
                           bool* rvalid, float* pts, float* pcos, float* dirs, float* dnorm,
                           int* srow, void* stream) {
  const int n = W * nl;
  if (n > 0) {
    ray_pick_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        ridx, N, c0, nl, W, K, (const float4*)rows, svalid, active, rvalid, pts, pcos, dirs,
        dnorm, srow);
  }
  return (int)cudaGetLastError();
}
