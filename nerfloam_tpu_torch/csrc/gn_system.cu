// K3: the GN tracker's residuals, count-balanced weights and 6x6 normal
// equations (port of nerfloam_tpu/core/tracking.py:217-244
// _residual_parts and 300-315, the two einsums).
//
// Per sample (ray n, column m of the M hits samples + K band/anchor
// columns): front = z cos < d - T, band = not front, not z cos > d + T and
// the ray's depth is ok; r = sdf - 1 (front) or z cos + (sdf - bias) T - d
// (band); J = [g s, (xyz - t) x g s] with s = 1 (front) or T (band). The
// balancing weights w_fs = fs_weight (1 - n_front / n), w_sdf = sdf_weight
// (1 - n_band / n) depend on the global counts, so one pass accumulates,
// per class, the unweighted sums J J^T (21 entries), J r (6) and r^2 (1)
// and the class count; the end combines w_fs * S_front + w_sdf * S_band.
//
// Deterministic two-stage reduction, no float atomics: a fixed grid of
// blocks walks the samples with a fixed stride, each block reduces its
// threads by warp shuffles and then across warps in order into one row of
// partial sums; one block then sums the rows in order and forms H, b and
// the loss. The result is the same on every run.
//
// Bound on the H100: it reads 36 B per sample (xyz, z, sdf, g, mask) plus
// 17 B per ray, ~5.3 MB at 2048 x 72, and does ~100 flops per sample; it
// is memory-bound (about 1.6 us at 3.35 TB/s), and in practice bound by
// its two launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 256;
constexpr int kCls = 28;         // 21 (J J^T upper) + 6 (J r) + 1 (r^2)
constexpr int kVals = 2 * kCls + 2;  // front sums, band sums, two counts

__device__ __forceinline__ void accumulate(float (&acc)[kCls], const float (&J)[6], float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += J[i] * J[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += J[i] * r;
  acc[27] += r * r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void gn_partial_kernel(const float* __restrict__ xyz, const float* __restrict__ z,
                                  const float* __restrict__ sdf, const float* __restrict__ g,
                                  const unsigned char* __restrict__ vmask,
                                  const float* __restrict__ pcos, const float* __restrict__ d_meas,
                                  const unsigned char* __restrict__ depth_ok,
                                  const float* __restrict__ bias_ray,
                                  const float* __restrict__ t_pos, int n, int MK, float T,
                                  float* __restrict__ partial) {
  float fr[kCls], bd[kCls];
#pragma unroll
  for (int k = 0; k < kCls; ++k) fr[k] = bd[k] = 0.0f;
  float n_fr = 0.0f, n_bd = 0.0f;
  const float t0 = t_pos[0], t1 = t_pos[1], t2 = t_pos[2];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    if (!vmask[i]) continue;
    int ray = i / MK;
    float zc = z[i] * pcos[ray];
    float d = d_meas[ray];
    bool front = zc < d - T;
    bool band = !front && !(zc > d + T) && depth_ok[ray];
    if (!front && !band) continue;
    float s = sdf[i];
    float r = front ? s - 1.0f : (zc + (s - bias_ray[ray]) * T) - d;
    float js = front ? 1.0f : T;
    float gx = g[3 * i] * js, gy = g[3 * i + 1] * js, gz = g[3 * i + 2] * js;
    float qx = xyz[3 * i] - t0, qy = xyz[3 * i + 1] - t1, qz = xyz[3 * i + 2] - t2;
    float J[6] = {gx, gy, gz, qy * gz - qz * gy, qz * gx - qx * gz, qx * gy - qy * gx};
    if (front) {
      accumulate(fr, J, r);
      n_fr += 1.0f;
    } else {
      accumulate(bd, J, r);
      n_bd += 1.0f;
    }
  }
  __shared__ float warp_part[kThreads / 32][kVals];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kCls; ++k) {
    float a = warp_sum(fr[k]);
    float b = warp_sum(bd[k]);
    if (lane == 0) {
      warp_part[warp][k] = a;
      warp_part[warp][kCls + k] = b;
    }
  }
  float a = warp_sum(n_fr), b = warp_sum(n_bd);
  if (lane == 0) {
    warp_part[warp][2 * kCls] = a;
    warp_part[warp][2 * kCls + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x < kVals) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w][threadIdx.x];
    partial[blockIdx.x * kVals + threadIdx.x] = s;
  }
}

__global__ void gn_final_kernel(const float* __restrict__ partial, int n_blocks,
                                float fs_weight, float sdf_weight, float* __restrict__ H,
                                float* __restrict__ b, float* __restrict__ loss) {
  __shared__ float tot[kVals];
  if (threadIdx.x < kVals) {
    float s = 0.0f;
    for (int k = 0; k < n_blocks; ++k) s += partial[k * kVals + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float nf = tot[2 * kCls], ns = tot[2 * kCls + 1];
  float all = fmaxf(nf + ns, 1.0f);
  float w_fs = fs_weight * (1.0f - nf / all);
  float w_sdf = sdf_weight * (1.0f - ns / all);
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j, ++k) {
      float h = w_fs * tot[k] + w_sdf * tot[kCls + k];
      H[6 * i + j] = h;
      H[6 * j + i] = h;
    }
  for (int i = 0; i < 6; ++i) b[i] = w_fs * tot[21 + i] + w_sdf * tot[kCls + 21 + i];
  loss[0] = w_fs * tot[27] + w_sdf * tot[kCls + 27];
}

}  // namespace

extern "C" int nl_gn_partial_values() { return kVals; }

extern "C" int nl_gn_blocks(int n) {
  int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// partial: nl_gn_blocks(n) x nl_gn_partial_values() floats of scratch
extern "C" int nl_gn_system(const float* xyz, const float* z, const float* sdf, const float* g,
                            const unsigned char* vmask, const float* pcos, const float* d_meas,
                            const unsigned char* depth_ok, const float* bias_ray,
                            const float* t_pos, int N, int MK, float T, float fs_weight,
                            float sdf_weight, float* partial, float* H, float* b, float* loss,
                            void* stream) {
  int n = N * MK;
  int nb = nl_gn_blocks(n);
  gn_partial_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      xyz, z, sdf, g, vmask, pcos, d_meas, depth_ok, bias_ray, t_pos, n, MK, T, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gn_final_kernel<<<1, 64, 0, (cudaStream_t)stream>>>(partial, nb, fs_weight, sdf_weight, H, b,
                                                      loss);
  return (int)cudaGetLastError();
}
