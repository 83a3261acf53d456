// K9a / K9b: the grid sampler's two passes (port of
// nerfloam_tpu/ops/raycast.py:65-85 march_occupancy and 88-130
// place_samples_cdf, with map/voxel_map.py:172-180 lookup_active inlined;
// raycast.py:346-381 sample_rays_cdf is the two in a row).
//
// K9a march: one warp per ray. Lane l takes slots s = 32 k + l; slot s is
// occupied when its midpoint t_c = (s + 0.5) * cstep lies within the
// ray's useful range t_cap and its cell floor((o + d t_c) / vs) holds an
// active voxel in grid_active. The warp's ballot gives each lane its
// inclusive count, so the cdf (R, S) (a running count of occupied slots)
// is written coalesced, and n_occ (R,) is the last entry.
// K9b place: one thread per (ray, sample m). The stratified quantile
// q = ((m + u) / M) * n_occ, in JAX's order; j = the number of cdf entries
// below q, found by binary search (the cdf is non-decreasing, so the lower
// bound equals JAX's compare-count), clipped to S - 1; frac =
// clip(q - (cdf_j - 1), 0, 1), z = (j + frac) * cstep; the fine cell
// floor((o + d z) / vs) is looked up in grid_active, and valid = n_occ > 0
// & aid >= 0 & z <= t_cap. Invalid samples get z = 0 and aid = -1.
//
// Bound on the H100: K9a reads one 4-byte grid_active cell per slot within
// range (the 19.9 MB grid stays in the 50 MB L2) and writes the (R, S) f32
// cdf; K9b reads log2(S) cdf entries and one grid cell per sample and
// writes z, aid, valid. Both are bound by those bytes; the arithmetic is a
// few dozen operations per slot or sample.
//
// Rounding: every product, sum and division that feeds a floor() or the
// quantile is written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn
// (and the library is built with -fmad=false), so cells, counts and depths
// agree exactly with the plain torch versions.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int grid_read(const int* grid, const float* o, const float* d, float t,
                                         float vs, const int* rmin, int Dx, int Dy, int Dz) {
  int c[3];
  for (int a = 0; a < 3; ++a)
    c[a] = (int)floorf(__fdiv_rn(__fadd_rn(o[a], __fmul_rn(d[a], t)), vs)) - rmin[a];
  if (c[0] < 0 || c[0] >= Dx || c[1] < 0 || c[1] >= Dy || c[2] < 0 || c[2] >= Dz) return -1;
  return grid[(c[0] * Dy + c[1]) * Dz + c[2]];
}

__global__ void march_occupancy_kernel(const int* __restrict__ grid_active,
                                       const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                                       const float* __restrict__ rays_o,
                                       const float* __restrict__ rays_d,
                                       const float* __restrict__ t_cap, int R, int S, float cstep,
                                       float vs, float* __restrict__ cdf,
                                       float* __restrict__ n_occ) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= R) return;
  const int r = warp;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
  }
  const float tcap = t_cap[r];
  const unsigned le = 0xffffffffu >> (31 - lane);  // lanes 0..lane
  int run = 0;
  for (int base = 0; base < S; base += 32) {
    int s = base + lane;
    bool occ = false;
    if (s < S) {
      float tc = __fmul_rn(__fadd_rn((float)s, 0.5f), cstep);
      occ = tc <= tcap && grid_read(grid_active, o, d, tc, vs, rmin, Dx, Dy, Dz) >= 0;
    }
    unsigned ballot = __ballot_sync(0xffffffffu, occ);
    if (s < S) cdf[(size_t)r * S + s] = (float)(run + __popc(ballot & le));
    run += __popc(ballot);
  }
  if (lane == 0) n_occ[r] = (float)run;
}

__global__ void place_samples_kernel(const int* __restrict__ grid_active,
                                     const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                                     const float* __restrict__ cdf,
                                     const float* __restrict__ n_occ,
                                     const float* __restrict__ rays_o,
                                     const float* __restrict__ rays_d,
                                     const float* __restrict__ t_cap, const float* __restrict__ u,
                                     int R, int S, int M, float cstep, float vs,
                                     float* __restrict__ z_out, int* __restrict__ aid_out,
                                     unsigned char* __restrict__ valid_out,
                                     unsigned char* __restrict__ ray_mask) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * M) return;
  int r = i / M, m = i - r * M;
  const float n = n_occ[r];
  const bool hit = n > 0.0f;
  if (m == 0) ray_mask[r] = hit;
  float q = __fmul_rn(__fdiv_rn(__fadd_rn((float)m, u[i]), (float)M), n);
  const float* row = cdf + (size_t)r * S;
  int lo = 0, hi = S;  // first entry >= q = the count of entries < q
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  int j = lo < S - 1 ? lo : S - 1;
  float frac = fminf(fmaxf(__fsub_rn(q, __fsub_rn(row[j], 1.0f)), 0.0f), 1.0f);
  float z = __fmul_rn(__fadd_rn((float)j, frac), cstep);
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
  }
  int aid = grid_read(grid_active, o, d, z, vs, rmin, Dx, Dy, Dz);
  bool valid = hit && aid >= 0 && z <= t_cap[r];
  z_out[i] = valid ? z : 0.0f;
  aid_out[i] = valid ? aid : -1;
  valid_out[i] = valid;
}

}  // namespace

extern "C" int nl_march_occupancy(const int* grid_active, const int* rmin, int Dx, int Dy, int Dz,
                                  const float* rays_o, const float* rays_d, const float* t_cap,
                                  int R, int S, float cstep, float vs, float* cdf, float* n_occ,
                                  void* stream) {
  if (R > 0) {
    const int threads = 128;  // 4 rays per block
    long long n = 32LL * R;
    march_occupancy_kernel<<<(int)((n + threads - 1) / threads), threads, 0,
                             (cudaStream_t)stream>>>(grid_active, rmin, Dx, Dy, Dz, rays_o,
                                                     rays_d, t_cap, R, S, cstep, vs, cdf, n_occ);
  }
  return (int)cudaGetLastError();
}

extern "C" int nl_place_samples_cdf(const int* grid_active, const int* rmin, int Dx, int Dy,
                                    int Dz, const float* cdf, const float* n_occ,
                                    const float* rays_o, const float* rays_d, const float* t_cap,
                                    const float* u, int R, int S, int M, float cstep, float vs,
                                    float* z, int* aid, unsigned char* valid,
                                    unsigned char* ray_mask, void* stream) {
  if (R > 0 && M > 0 && S > 0) {
    const int threads = 128;
    place_samples_kernel<<<(R * M + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        grid_active, rmin, Dx, Dy, Dz, cdf, n_occ, rays_o, rays_d, t_cap, u, R, S, M, cstep, vs,
        z, aid, valid, ray_mask);
  }
  return (int)cudaGetLastError();
}
