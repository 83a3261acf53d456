// K1 / K2: the fused hits-sampler field and its backward.
//
// K1 (hits_field_fwd) replaces the XLA fusion of
//   nerfloam_tpu/ops/raycast.py:248-302  sample_from_hits,
//   nerfloam_tpu/ops/raycast.py:305-324  resolve_cells_in_hits,
//   nerfloam_tpu/core/render.py:91-105   hit_rows / select_rows,
//   nerfloam_tpu/core/render.py:72-87    field_from_embs (up to the decoder),
//   nerfloam_tpu/ops/interp.py:22-47     trilinear interpolation,
// as driven by render.py:132-147 (BA) and tracking.py:254-261 (GN).
// One thread per (ray, sample): stratified inverse-CDF depth by
// compare-count over the ray's <= H cdf entries, xyz = o + d z, the cell
// floor(xyz / vs) re-resolved against the ray's hit cells (the FIRST hit
// with that cell and aid >= 0: duplicate slabs of one cell carry the same
// aid, so JAX's one-hot average over them is this one row), one 128-float
// packed row, and the 8 trilinear weights -> 16 features. Invalid samples
// get zero features and aid -1.
//
// K2 (hits_field_bwd) is K1's backward under jax.value_and_grad
// (core/ba.py:335) and jax.grad (core/tracking.py:214), in two passes.
// d xyz: one thread per (ray, sample), from the derivative of the
// trilinear weights (the voxel center is fixed: floor has zero gradient).
// d packed (A, 128), when asked: one thread per (packed row, float). The
// wrapper sorts the valid samples by row (a stable sort, so each row's
// samples stay in ascending sample index) and hands in the sorted sample
// list and each row's segment; the thread adds its row's samples' w_corner
// * d feats in that order. No atomics and no zero fill: the table is the
// same on every run. (The first version scattered 128 float atomics per
// valid sample; their order changed from run to run, and BA's Adam steps,
// which normalise each entry's gradient, turned that noise into different
// maps and, on marginal frames, different trajectories.) Invalid samples
// contribute nothing.
//
// Bound on the H100: one 512 B packed row per valid sample (K1 reads it,
// the d xyz pass reads it again), and the (A, 128) d packed written once.
// Neighbouring samples of a ray mostly share rows, so the reads hit L1/L2;
// the 128 threads of a row read the same samples (broadcast loads).
//
// Rounding: the sample position and the cell go through __fmul_rn /
// __fadd_rn / __fdiv_rn (and -fmad=false), in the order of the JAX code,
// so z, valid and aid agree exactly with the plain torch version.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;        // feature width
constexpr int kRow = 8 * kF;  // packed row width

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// per-axis interpolation factors: f[a][0] = 1 - p_a (corner bit 0),
// f[a][1] = p_a (corner bit 1), for p = (xyz - center) / vs + 0.5
__device__ __forceinline__ void axis_factors(const float* xyz, float vs, float f[3][2]) {
  for (int a = 0; a < 3; ++a) {
    float center = __fmul_rn(__fadd_rn(floorf(__fdiv_rn(xyz[a], vs)), 0.5f), vs);
    float p = __fadd_rn(__fdiv_rn(__fsub_rn(xyz[a], center), vs), 0.5f);
    f[a][0] = __fsub_rn(1.0f, p);
    f[a][1] = p;
  }
}

__global__ void hits_field_fwd_kernel(
    const int* __restrict__ h_aid, const float* __restrict__ h_tnear,
    const float* __restrict__ h_seg, const float* __restrict__ h_cdf,
    const int* __restrict__ h_cell, const float* __restrict__ u,
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ packed, int R, int M, int H, float vs, float lo, float hi,
    float* __restrict__ z_out, unsigned char* __restrict__ valid_out,
    int* __restrict__ aid_out, float* __restrict__ xyz_out, float* __restrict__ feats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * M) return;
  int r = i / M, m = i - r * M;
  const float* cdf = h_cdf + r * H;
  float total = cdf[H - 1];
  float q = __fmul_rn(__fdiv_rn(__fadd_rn((float)m, u[i]), (float)M), total);
  int j = 0;
  for (int h = 0; h < H; ++h) j += cdf[h] < q;
  j = min(j, H - 1);
  float cdf_j = cdf[j], seg_j = h_seg[r * H + j], tn_j = h_tnear[r * H + j];
  int aid_j = h_aid[r * H + j];
  float frac = clampf(__fdiv_rn(__fsub_rn(q, __fsub_rn(cdf_j, seg_j)), seg_j > 0.0f ? seg_j : 1.0f),
                      0.0f, 1.0f);
  float z = __fadd_rn(tn_j, __fmul_rn(clampf(frac, lo, hi), seg_j));
  bool pvalid = total > 0.0f && aid_j >= 0 && seg_j > 0.0f;
  if (!pvalid) z = 0.0f;

  float xyz[3];
  int c[3];
  for (int a = 0; a < 3; ++a) {
    xyz[a] = __fadd_rn(rays_o[3 * r + a], __fmul_rn(rays_d[3 * r + a], z));
    c[a] = (int)floorf(__fdiv_rn(xyz[a], vs));
    xyz_out[3 * i + a] = xyz[a];
  }
  int aid = -1;
  for (int h = 0; h < H; ++h) {
    const int* hc = h_cell + (r * H + h) * 3;
    if (h_aid[r * H + h] >= 0 && hc[0] == c[0] && hc[1] == c[1] && hc[2] == c[2]) {
      aid = h_aid[r * H + h];
      break;
    }
  }
  bool valid = pvalid && aid >= 0;
  z_out[i] = z;
  valid_out[i] = valid;
  aid_out[i] = valid ? aid : -1;

  float acc[kF];
  for (int k = 0; k < kF; ++k) acc[k] = 0.0f;
  if (valid) {
    float f[3][2];
    axis_factors(xyz, vs, f);
    const float4* row = reinterpret_cast<const float4*>(packed + (size_t)aid * kRow);
    for (int jc = 0; jc < 8; ++jc) {
      float w = __fmul_rn(__fmul_rn(f[0][(jc >> 2) & 1], f[1][(jc >> 1) & 1]), f[2][jc & 1]);
      for (int k4 = 0; k4 < kF / 4; ++k4) {
        float4 v = row[jc * (kF / 4) + k4];
        acc[4 * k4 + 0] = __fadd_rn(acc[4 * k4 + 0], __fmul_rn(w, v.x));
        acc[4 * k4 + 1] = __fadd_rn(acc[4 * k4 + 1], __fmul_rn(w, v.y));
        acc[4 * k4 + 2] = __fadd_rn(acc[4 * k4 + 2], __fmul_rn(w, v.z));
        acc[4 * k4 + 3] = __fadd_rn(acc[4 * k4 + 3], __fmul_rn(w, v.w));
      }
    }
  }
  float4* out = reinterpret_cast<float4*>(feats + (size_t)i * kF);
  for (int k4 = 0; k4 < kF / 4; ++k4)
    out[k4] = make_float4(acc[4 * k4], acc[4 * k4 + 1], acc[4 * k4 + 2], acc[4 * k4 + 3]);
}

__global__ void hits_field_bwd_kernel(const float* __restrict__ dfeats,
                                      const float* __restrict__ xyz_in,
                                      const int* __restrict__ aid_in,
                                      const unsigned char* __restrict__ valid_in,
                                      const float* __restrict__ packed, int n, float vs,
                                      float* __restrict__ dxyz) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float g[3] = {0.0f, 0.0f, 0.0f};
  if (valid_in[i]) {
    float xyz[3] = {xyz_in[3 * i], xyz_in[3 * i + 1], xyz_in[3 * i + 2]};
    float f[3][2];
    axis_factors(xyz, vs, f);
    float df[kF];
    const float4* dsrc = reinterpret_cast<const float4*>(dfeats + (size_t)i * kF);
    for (int k4 = 0; k4 < kF / 4; ++k4) {
      float4 v = dsrc[k4];
      df[4 * k4] = v.x;
      df[4 * k4 + 1] = v.y;
      df[4 * k4 + 2] = v.z;
      df[4 * k4 + 3] = v.w;
    }
    size_t base = (size_t)aid_in[i] * kRow;
    const float* row = packed + base;
    for (int jc = 0; jc < 8; ++jc) {
      int b0 = (jc >> 2) & 1, b1 = (jc >> 1) & 1, b2 = jc & 1;
      float f0 = f[0][b0], f1 = f[1][b1], f2 = f[2][b2];
      // d(row_j . dfeats) weighted by d w_j / d p_a = sign_a * (other two factors)
      float dot = 0.0f;
      for (int k = 0; k < kF; ++k) dot += row[jc * kF + k] * df[k];
      g[0] += (b0 ? dot : -dot) * f1 * f2;
      g[1] += (b1 ? dot : -dot) * f0 * f2;
      g[2] += (b2 ? dot : -dot) * f0 * f1;
    }
    for (int a = 0; a < 3; ++a) g[a] = __fdiv_rn(g[a], vs);
  }
  for (int a = 0; a < 3; ++a) dxyz[3 * i + a] = g[a];
}

// order: the sample indices sorted by packed row (invalid samples last);
// seg[a] .. seg[a + 1]: row a's part of it
__global__ void hits_field_bwd_rows_kernel(const float* __restrict__ dfeats,
                                           const float* __restrict__ xyz_in,
                                           const long long* __restrict__ order,
                                           const long long* __restrict__ seg, long long n_out,
                                           float vs, float* __restrict__ dpacked) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  long long a = t / kRow;
  int e = (int)(t - a * kRow);
  int jc = e / kF, k = e - jc * kF;
  int b0 = (jc >> 2) & 1, b1 = (jc >> 1) & 1, b2 = jc & 1;
  float acc = 0.0f;
  for (long long p = seg[a]; p < seg[a + 1]; ++p) {
    long long i = order[p];
    float xyz[3] = {xyz_in[3 * i], xyz_in[3 * i + 1], xyz_in[3 * i + 2]};
    float f[3][2];
    axis_factors(xyz, vs, f);
    float w = __fmul_rn(__fmul_rn(f[0][b0], f[1][b1]), f[2][b2]);
    acc = __fadd_rn(acc, __fmul_rn(w, dfeats[i * kF + k]));
  }
  dpacked[t] = acc;
}

}  // namespace

extern "C" int nl_hits_field_fwd(const int* h_aid, const float* h_tnear, const float* h_seg,
                                 const float* h_cdf, const int* h_cell, const float* u,
                                 const float* rays_o, const float* rays_d, const float* packed,
                                 int R, int M, int H, float vs, float lo, float hi, float* z,
                                 unsigned char* valid, int* aid, float* xyz, float* feats,
                                 void* stream) {
  int n = R * M;
  if (n > 0) {
    const int threads = 128;
    hits_field_fwd_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        h_aid, h_tnear, h_seg, h_cdf, h_cell, u, rays_o, rays_d, packed, R, M, H, vs, lo, hi, z,
        valid, aid, xyz, feats);
  }
  return (int)cudaGetLastError();
}

// d xyz (n, 3); then, if dpacked is not null, d packed (A, 128) from the
// samples sorted by row (order (n,), seg (A + 1,))
extern "C" int nl_hits_field_bwd(const float* dfeats, const float* xyz, const int* aid,
                                 const unsigned char* valid, const float* packed, int n,
                                 float vs, float* dxyz, const long long* order,
                                 const long long* seg, int A, float* dpacked, void* stream) {
  const int threads = 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    hits_field_bwd_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(dfeats, xyz, aid, valid,
                                                                         packed, n, vs, dxyz);
  if (dpacked != nullptr && A > 0) {
    long long n_out = (long long)A * kRow;
    hits_field_bwd_rows_kernel<<<(int)((n_out + threads - 1) / threads), threads, 0, s>>>(
        dfeats, xyz, order, seg, n_out, vs, dpacked);
  }
  return (int)cudaGetLastError();
}
