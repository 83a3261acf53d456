// pose_rays: a pose's rays, origins and directions in the world, from its
// pose6 [t, w] and the rays' directions in the sensor frame, one launch
// forward, and the pose's gradient from the rays' cotangents, one launch
// backward (ops/se3.py, pose_rays of CUDA tensors: BA's iterations and its
// superset, the Adam tracker's iterations and march, the tp BA iteration,
// the GN tracker's first rotation). Port of the XLA fusion of
// nerfloam_tpu/core/ba.py:253-256 (vmap(se3.rotate_dirs) and the
// translation broadcast) and of se3.rotate_dirs in the trackers
// (nerfloam_tpu/core/tracking.py:249, 436); no Pallas kernel.
//
// Forward, frame w's rays n: R = exp_so3(w) (csrc/so3.cuh, the plain
// chain's rounding), wdirs[n] = d[n] R^T with each entry
// fma(d2, R_i2, fma(d1, R_i1, d0 * R_i0)) (se3.rotate_rows, bit for bit),
// origins[n] = t. The grid is (ceil(N / 256), W): one thread of a block
// builds its frame's R and t in shared memory, then every thread writes its
// ray. Origin rows are written only for a window (W > 1, BA's layout, in
// the same pass: no reshape copy); one frame's origin is its t, which the
// wrapper expands (row stride 0, as K1, K4, K8 and K9a read it). R and t
// of each frame are written too (the GN tracker's first rotation).
//
// Backward, one block of 512 threads a frame: each thread adds its rays'
// terms of dR = sum_n gd[n] d[n]^T (9, fused multiply-adds) and of
// dt = sum_n go[n] (3) in ray order at a stride of 512, the 12 partial
// sums are added across a warp by __shfl_xor_sync and across the 16 warps
// in warp order by one thread, which then takes exp_so3's backward
// (so3.cuh's exp_so3_vjp) of dR and writes d pose[w] = [dt, dw]. No
// atomics: a run repeats bit for bit. The sums run in another order than
// autograd's of the plain chain, so the gradient agrees with it to
// rounding (chip_smoke's [pose_rays] states the tolerance).
//
// Bound: 24 bytes a ray each way (~0.09 us for BA's window of 4 x 2048 at
// 3.35 TB/s) and ~20 operations a ray; at these sizes the launch is the
// cost. The kernels replace exp_so3.cu's launches, the batched product,
// the origins' copy, and in the backward the product for dR, the
// contiguity copies, the slices' fills and the sum for the origins.

#include <cuda_runtime.h>

#include "so3.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kWarps = kBwdThreads / 32;

__global__ void __launch_bounds__(kFwdThreads)
    pose_rays_fwd_kernel(const float* __restrict__ poses, const float* __restrict__ dirs, int n,
                         float* __restrict__ wdirs, float* __restrict__ origins,
                         float* __restrict__ R_out, float* __restrict__ t_out) {
  __shared__ float sR[9];
  __shared__ float st[3];
  const size_t w = blockIdx.y;
  if (threadIdx.x == 0) {
    const float* p = poses + 6 * w;
    float R[9];
    exp_so3(p[3], p[4], p[5], R);
#pragma unroll
    for (int k = 0; k < 9; ++k) sR[k] = R[k];
    st[0] = p[0];
    st[1] = p[1];
    st[2] = p[2];
    if (blockIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R_out[9 * w + k] = R[k];
      t_out[3 * w] = p[0];
      t_out[3 * w + 1] = p[1];
      t_out[3 * w + 2] = p[2];
    }
  }
  __syncthreads();
  const int r = blockIdx.x * kFwdThreads + threadIdx.x;
  if (r >= n) return;
  const size_t row = w * n + r;
  const float* d = dirs + 3 * row;
  float o[3];
  rotate_row(sR, d[0], d[1], d[2], o);
  float* wd = wdirs + 3 * row;
  wd[0] = o[0];
  wd[1] = o[1];
  wd[2] = o[2];
  if (origins != nullptr) {
    float* og = origins + 3 * row;
    og[0] = st[0];
    og[1] = st[1];
    og[2] = st[2];
  }
}

__global__ void __launch_bounds__(kBwdThreads)
    pose_rays_bwd_kernel(const float* __restrict__ poses, const float* __restrict__ dirs,
                         const float* __restrict__ g_orig, const float* __restrict__ g_wdirs,
                         int n, float* __restrict__ g_pose) {
  __shared__ float part[kWarps][12];
  const size_t w = blockIdx.x;
  // acc[3 i + j]: dR_ij = sum gd_i d_j; acc[9 + i]: dt_i = sum go_i
  float acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = 0.0f;
  for (int r = threadIdx.x; r < n; r += kBwdThreads) {
    const size_t row = w * n + r;
    if (g_wdirs != nullptr) {
      const float* d = dirs + 3 * row;
      const float* g = g_wdirs + 3 * row;
      const float d0 = d[0], d1 = d[1], d2 = d[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float gi = g[i];
        acc[3 * i] = __fmaf_rn(gi, d0, acc[3 * i]);
        acc[3 * i + 1] = __fmaf_rn(gi, d1, acc[3 * i + 1]);
        acc[3 * i + 2] = __fmaf_rn(gi, d2, acc[3 * i + 2]);
      }
    }
    if (g_orig != nullptr) {
      const float* g = g_orig + 3 * row;
      acc[9] = __fadd_rn(acc[9], g[0]);
      acc[10] = __fadd_rn(acc[10], g[1]);
      acc[11] = __fadd_rn(acc[11], g[2]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 12; ++k) acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float s[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = part[0][k];
  for (int q = 1; q < kWarps; ++q) {
#pragma unroll
    for (int k = 0; k < 12; ++k) s[k] = __fadd_rn(s[k], part[q][k]);
  }
  const float* p = poses + 6 * w;
  float gw[3];
  exp_so3_vjp(p[3], p[4], p[5], s, gw);
  float* o = g_pose + 6 * w;
  o[0] = s[9];
  o[1] = s[10];
  o[2] = s[11];
  o[3] = gw[0];
  o[4] = gw[1];
  o[5] = gw[2];
}

}  // namespace

// poses (W, 6), dirs (W, n, 3) f32 contiguous; wdirs (W, n, 3), origins
// (W, n, 3) or null (not written), R_out (W, 3, 3), t_out (W, 3)
extern "C" int nl_pose_rays_fwd(const float* poses, const float* dirs, int W, int n,
                                float* wdirs, float* origins, float* R_out, float* t_out,
                                void* stream) {
  if (W > 0) {
    const dim3 grid(n > 0 ? (n + kFwdThreads - 1) / kFwdThreads : 1, W);
    pose_rays_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
        poses, dirs, n, wdirs, origins, R_out, t_out);
  }
  return (int)cudaGetLastError();
}

// g_orig, g_wdirs: (W, n, 3) f32 contiguous cotangents of the origins and
// the directions, or null (zero); g_pose (W, 6)
extern "C" int nl_pose_rays_bwd(const float* poses, const float* dirs, const float* g_orig,
                                const float* g_wdirs, int W, int n, float* g_pose,
                                void* stream) {
  if (W > 0) {
    pose_rays_bwd_kernel<<<W, kBwdThreads, 0, (cudaStream_t)stream>>>(poses, dirs, g_orig,
                                                                     g_wdirs, n, g_pose);
  }
  return (int)cudaGetLastError();
}
