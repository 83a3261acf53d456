// K4: per-ray hit table (port of nerfloam_tpu/ops/raycast.py:159-220
// build_hit_table, with map/voxel_map.py:172-181 lookup_active inlined).
//
// One thread per ray walks the S coarse probes in order. A probe at
// t_c = (s + 0.5) * cstep counts while t_c <= t_cap + cstep; its cell
// floor((o + d t_c) / vs) is looked up in grid_active (-1 outside the
// region); a hit is a probe whose active id is >= 0 and differs from the
// previous probe's. The first H hits are kept, then each gets the exact
// slab test against its cell (re-derived from the probe point), and the
// ray's inclusive cdf of segment lengths is summed sequentially.
//
// Bound on the H100: S random 4-byte reads per ray into grid_active
// (288*288*60 int32 = 19.9 MB at the bench shapes, which stays resident in
// the 50 MB L2); everything else is registers. The walk stops at the ray's
// useful range or at H hits, so most rays read far fewer than S cells.
//
// Rounding: every product and sum that feeds a floor() is written with
// __fmul_rn / __fadd_rn / __fdiv_rn (and the library is built with
// -fmad=false), so no FMA contraction or approximate division moves a
// probe across a voxel face; the plain torch version gets the same cells.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxHits = 64;

__device__ __forceinline__ int grid_read(const int* grid, int cx, int cy, int cz,
                                         const int* rmin, int Dx, int Dy, int Dz) {
  int x = cx - rmin[0], y = cy - rmin[1], z = cz - rmin[2];
  if (x < 0 || x >= Dx || y < 0 || y >= Dy || z < 0 || z >= Dz) return -1;
  return grid[(x * Dy + y) * Dz + z];
}

__global__ void hit_table_kernel(const int* __restrict__ grid_active,
                                 const int* __restrict__ region_min, int Dx, int Dy, int Dz,
                                 const float* __restrict__ rays_o,
                                 const float* __restrict__ rays_d,
                                 const float* __restrict__ t_cap, int R, int S, int H,
                                 float cstep, float vs, int* __restrict__ aid,
                                 float* __restrict__ t_near, float* __restrict__ seg,
                                 float* __restrict__ cdf, int* __restrict__ cell,
                                 unsigned char* __restrict__ ray_mask) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
  }
  const float tlim = __fadd_rn(t_cap[r], cstep);

  int hit_aid[kMaxHits];
  int hit_slot[kMaxHits];
  int n = 0, prev = -2;
  for (int s = 0; s < S && n < H; ++s) {
    float tc = __fmul_rn(__fadd_rn((float)s, 0.5f), cstep);
    if (!(tc <= tlim)) break;  // every later probe is past the range too
    int c[3];
    for (int a = 0; a < 3; ++a)
      c[a] = (int)floorf(__fdiv_rn(__fadd_rn(o[a], __fmul_rn(d[a], tc)), vs));
    int id = grid_read(grid_active, c[0], c[1], c[2], region_min, Dx, Dy, Dz);
    if (id >= 0 && id != prev) {
      hit_aid[n] = id;
      hit_slot[n] = s;
      ++n;
    }
    prev = id;
  }

  float inv_d[3];
  for (int a = 0; a < 3; ++a)
    inv_d[a] = __fdiv_rn(1.0f, fabsf(d[a]) < 1e-9f ? 1e-9f : d[a]);
  const float tcap = t_cap[r];
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) {
    // padding entries take slot 0, exactly like the JAX table
    int a_h = h < n ? hit_aid[h] : -1;
    int s = h < n ? hit_slot[h] : 0;
    float ht = __fmul_rn(__fadd_rn((float)s, 0.5f), cstep);
    float tn = -CUDART_INF_F, tf = CUDART_INF_F;
    for (int a = 0; a < 3; ++a) {
      float hc = floorf(__fdiv_rn(__fadd_rn(o[a], __fmul_rn(d[a], ht)), vs));
      cell[(r * H + h) * 3 + a] = (int)hc;
      float vmin = __fmul_rn(hc, vs);
      float vmax = __fadd_rn(vmin, vs);
      float t0 = __fmul_rn(__fsub_rn(vmin, o[a]), inv_d[a]);
      float t1 = __fmul_rn(__fsub_rn(vmax, o[a]), inv_d[a]);
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    tn = fmaxf(tn, 0.0f);
    tf = fminf(tf, tcap);
    float sg = a_h >= 0 ? fmaxf(__fsub_rn(tf, tn), 0.0f) : 0.0f;
    acc = __fadd_rn(acc, sg);
    aid[r * H + h] = a_h;
    t_near[r * H + h] = tn;
    seg[r * H + h] = sg;
    cdf[r * H + h] = acc;
  }
  ray_mask[r] = acc > 0.0f;
}

}  // namespace

extern "C" int nl_hit_table_max_hits() { return kMaxHits; }

extern "C" int nl_hit_table(const int* grid_active, const int* region_min, int Dx, int Dy,
                            int Dz, const float* rays_o, const float* rays_d,
                            const float* t_cap, int R, int S, int H, float cstep, float vs,
                            int* aid, float* t_near, float* seg, float* cdf, int* cell,
                            unsigned char* ray_mask, void* stream) {
  if (R > 0) {
    const int threads = 128;
    hit_table_kernel<<<(R + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        grid_active, region_min, Dx, Dy, Dz, rays_o, rays_d, t_cap, R, S, H, cstep, vs, aid,
        t_near, seg, cdf, cell, ray_mask);
  }
  return (int)cudaGetLastError();
}
