// K8 forward: field features at explicit sample depths through the dense
// active grid (port of nerfloam_tpu/core/render.py:181-202 band_samples
// and 42-69 field_at up to the decoder, with map/voxel_map.py:172-180
// lookup_active inlined; driven by the band/anchor columns of
// core/tracking.py:271-298 and core/ba.py:282-304, and by the surface-bias
// probe of core/ba.py:398-413).
//
// One thread per sample: xyz = o + d z (or a given xyz, for the probe's
// transformed points), the cell floor(xyz / vs), its active id from
// grid_active (-1 outside the region), valid = aid >= 0 & ray_valid &
// z > 0 (aid is -1 where not valid), then one 128-float packed row and the 8 trilinear weights -> 16
// features (zero for invalid samples, whose sdf the caller masks).
// The backward is K2 (csrc/hits_field.cu): it takes per-sample (xyz, aid,
// valid) in the active index space and interpolates in the sample's own
// cell, which is this function's derivative.
//
// Bound on the H100: one random 4-byte grid_active read (the 19.9 MB grid
// stays in L2) and one 512 B packed row per valid sample, plus 76 B of
// outputs per sample; memory-bound.
//
// Rounding: xyz and the cell go through __fmul_rn / __fadd_rn / __fdiv_rn
// in the JAX order (and -fmad=false), so aid and valid agree exactly with
// the plain torch version.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;
constexpr int kRow = 8 * kF;

__global__ void active_field_fwd_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ z, const float* __restrict__ xyz_in,
    const unsigned char* __restrict__ ray_valid, const int* __restrict__ grid_active,
    const int* __restrict__ rmin, int Dx, int Dy, int Dz, const float* __restrict__ packed,
    int R, int K, float vs, int* __restrict__ aid_out, unsigned char* __restrict__ valid_out,
    float* __restrict__ xyz_out, float* __restrict__ feats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * K) return;
  int r = i / K;
  float zi = z[i];
  float xyz[3];
  int c[3];
  for (int a = 0; a < 3; ++a) {
    xyz[a] = xyz_in != nullptr ? xyz_in[3 * i + a]
                               : __fadd_rn(rays_o[3 * r + a], __fmul_rn(rays_d[3 * r + a], zi));
    c[a] = (int)floorf(__fdiv_rn(xyz[a], vs)) - rmin[a];
    xyz_out[3 * i + a] = xyz[a];
  }
  int aid = -1;
  if (c[0] >= 0 && c[0] < Dx && c[1] >= 0 && c[1] < Dy && c[2] >= 0 && c[2] < Dz)
    aid = grid_active[(c[0] * Dy + c[1]) * Dz + c[2]];
  bool valid = aid >= 0 && ray_valid[r] && zi > 0.0f;
  aid_out[i] = valid ? aid : -1;
  valid_out[i] = valid;

  float acc[kF];
  for (int k = 0; k < kF; ++k) acc[k] = 0.0f;
  if (valid) {
    float f[3][2];
    for (int a = 0; a < 3; ++a) {
      float center = __fmul_rn(__fadd_rn(floorf(__fdiv_rn(xyz[a], vs)), 0.5f), vs);
      float p = __fadd_rn(__fdiv_rn(__fsub_rn(xyz[a], center), vs), 0.5f);
      f[a][0] = __fsub_rn(1.0f, p);
      f[a][1] = p;
    }
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

}  // namespace

// rays_o / rays_d (R, 3) with z (R, K), or xyz_in (R*K, 3) with rays_o and
// rays_d null; ray_valid (R,)
extern "C" int nl_active_field_fwd(const float* rays_o, const float* rays_d, const float* z,
                                   const float* xyz_in, const unsigned char* ray_valid,
                                   const int* grid_active, const int* rmin, int Dx, int Dy,
                                   int Dz, const float* packed, int R, int K, float vs, int* aid,
                                   unsigned char* valid, float* xyz, float* feats, void* stream) {
  int n = R * K;
  if (n > 0) {
    const int threads = 128;
    active_field_fwd_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        rays_o, rays_d, z, xyz_in, ray_valid, grid_active, rmin, Dx, Dy, Dz, packed, R, K, vs,
        aid, valid, xyz, feats);
  }
  return (int)cudaGetLastError();
}
