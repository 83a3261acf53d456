// K8 forward: field features at explicit sample depths through the dense
// active grid (port of nerfloam_tpu/core/render.py:181-202 band_samples
// and 42-69 field_at up to the decoder, with map/voxel_map.py:172-180
// lookup_active inlined; driven by the band/anchor columns of
// core/tracking.py:271-298 and core/ba.py:282-304, by the grid sampler's
// columns, and by the surface-bias probe of core/ba.py:398-413).
//
// Per sample: xyz = o + d z (or a given xyz, for the probe's transformed
// points), the cell floor(xyz / vs), its active id from grid_active (-1
// outside the region), valid = aid >= 0 & ray_valid & z > 0 (aid is -1
// where not valid), then one 128-float packed row and the 8 trilinear
// weights -> 16 features (zero for invalid samples, whose sdf the caller
// masks). The backward is K2 (csrc/hits_field.cu): it takes per-sample
// (xyz, aid, valid) in the active index space and interpolates in the
// sample's own cell, which is this function's derivative.
//
// Bound on the H100: one random 4-byte grid_active read (the grid stays in
// L2) and one 512 B packed row per valid sample, plus 76 B of outputs per
// sample; memory-bound. At the band shape (2048 x 8) the work is too small
// to stream, so what holds it is latency: the chain sample -> grid cell ->
// row. Design against that:
//   - four threads per sample (a quad of lanes). Lane 0 of the quad reads
//     the ray, the depth and the grid cell once and hands the active id
//     and the cell fraction p to the other three by shuffles; it alone
//     writes aid, valid and xyz;
//   - each lane owns one float4 of the 16 features and reads that float4
//     from each of the 8 corner rows: 8 independent 16-byte loads in
//     flight (the quad reads 64 contiguous bytes a corner), not one thread
//     walking the 512 B row through one accumulator chain;
//   - the origin is read with a row stride of 0 (the trackers' one origin
//     expanded to every ray) or 3, so no caller copies it.
// Four times the threads of one thread a sample: 512 blocks of 128 at the
// band shape instead of 128 (under one wave on 132 SMs).
//
// Rounding: xyz and the cell go through __fmul_rn / __fadd_rn / __fdiv_rn
// in the JAX order (and -fmad=false), so aid and valid agree exactly with
// the plain torch version; each feature is added over corners 0..7 in order
// with __fmul_rn / __fadd_rn, the same operations in the same order as one
// thread a sample did.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;
constexpr int kRow4 = 8 * kF / 4;  // float4s in a packed row
constexpr int kThreads = 128;       // 32 samples a block

__global__ void active_field_fwd_kernel(
    const float* __restrict__ rays_o, int o_stride, const float* __restrict__ rays_d,
    const float* __restrict__ z, const float* __restrict__ xyz_in,
    const unsigned char* __restrict__ ray_valid, const int* __restrict__ grid_active,
    const int* __restrict__ rmin, int Dx, int Dy, int Dz, const float4* __restrict__ packed,
    int n, int K, float vs, int* __restrict__ aid_out, unsigned char* __restrict__ valid_out,
    float* __restrict__ xyz_out, float4* __restrict__ feats) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int i = t >> 2, q = t & 3;
  const unsigned quad_lead = (threadIdx.x & 31) & ~3u;
  // whole quads are in or out together (n * 4 threads), so the shuffles
  // below run on full quads
  if (i >= n) return;
  const unsigned quad_mask = 0xfu << quad_lead;
  int aid = -1;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (q == 0) {
    const int r = i / K;
    const float zi = z[i];
    const bool ray_ok = ray_valid[r];  // read with the depth, not after the grid cell
    float xyz[3];
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xyz[a] = xyz_in != nullptr
                   ? xyz_in[3 * i + a]
                   : __fadd_rn(rays_o[(size_t)o_stride * r + a], __fmul_rn(rays_d[3 * r + a], zi));
      const float fl = floorf(__fdiv_rn(xyz[a], vs));
      c[a] = (int)fl - rmin[a];
      const float center = __fmul_rn(__fadd_rn(fl, 0.5f), vs);
      p[a] = __fadd_rn(__fdiv_rn(__fsub_rn(xyz[a], center), vs), 0.5f);
      xyz_out[3 * i + a] = xyz[a];
    }
    if (c[0] >= 0 && c[0] < Dx && c[1] >= 0 && c[1] < Dy && c[2] >= 0 && c[2] < Dz)
      aid = grid_active[(c[0] * Dy + c[1]) * Dz + c[2]];
    const bool valid = aid >= 0 && ray_ok && zi > 0.0f;
    aid = valid ? aid : -1;
    aid_out[i] = aid;
    valid_out[i] = valid;
  }
  aid = __shfl_sync(quad_mask, aid, quad_lead);
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __shfl_sync(quad_mask, p[a], quad_lead);

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (aid >= 0) {
    const float f[3][2] = {{__fsub_rn(1.0f, p[0]), p[0]},
                           {__fsub_rn(1.0f, p[1]), p[1]},
                           {__fsub_rn(1.0f, p[2]), p[2]}};
    const float4* row = packed + (size_t)aid * kRow4 + q;
    float4 v[8];
#pragma unroll
    for (int jc = 0; jc < 8; ++jc) v[jc] = row[jc * (kF / 4)];
#pragma unroll
    for (int jc = 0; jc < 8; ++jc) {
      const float w =
          __fmul_rn(__fmul_rn(f[0][(jc >> 2) & 1], f[1][(jc >> 1) & 1]), f[2][jc & 1]);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, v[jc].x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, v[jc].y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w, v[jc].z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w, v[jc].w));
    }
  }
  feats[(size_t)i * (kF / 4) + q] = acc;
}

}  // namespace

// rays_o (R, 3) with row stride o_stride (0 or 3) and rays_d (R, 3) with
// z (R, K), or xyz_in (R*K, 3) with rays_o and rays_d null; ray_valid (R,)
extern "C" int nl_active_field_fwd(const float* rays_o, int o_stride, const float* rays_d,
                                   const float* z, const float* xyz_in,
                                   const unsigned char* ray_valid, const int* grid_active,
                                   const int* rmin, int Dx, int Dy, int Dz, const float* packed,
                                   int R, int K, float vs, int* aid, unsigned char* valid,
                                   float* xyz, float* feats, void* stream) {
  const int n = R * K;
  if (n > 0) {
    const long long threads = 4LL * n;
    active_field_fwd_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                              (cudaStream_t)stream>>>(
        rays_o, o_stride, rays_d, z, xyz_in, ray_valid, grid_active, rmin, Dx, Dy, Dz,
        reinterpret_cast<const float4*>(packed), n, K, vs, aid, valid, xyz,
        reinterpret_cast<float4*>(feats));
  }
  return (int)cudaGetLastError();
}
