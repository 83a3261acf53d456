// K9a / K9b: the grid sampler's two passes (port of
// nerfloam_tpu/ops/raycast.py:65-85 march_occupancy and 88-130
// place_samples_cdf, with map/voxel_map.py:172-180 lookup_active inlined;
// raycast.py:346-381 sample_rays_cdf is the two in a row).
//
// K9a march: launched as part of making a placer (CdfPlacer.march), it
// reads the fixed arguments from the PlaceArgs that K9b then uses (grid,
// rmin, dims, t_cap, cdf, n_occ, C rays, S slots, cstep, vs). One warp per
// ray; lane l takes slots s = 32 k + l. Slot s is occupied when its
// midpoint t_c = (s + 0.5) * cstep lies within the ray's useful range t_cap
// and its cell floor((o + d t_c) / vs) holds an active voxel in
// grid_active. The lane's rounds go four at a time: it computes the four
// slots' cells and issues their four grid loads before the first ballot,
// so a ray waits about one load latency per 128 slots (the loop it
// replaced waited one per 32, one after another); then the warp's ballots
// in slot order give each lane its inclusive count, so the cdf (C, S) (a
// running count of occupied slots) is written coalesced, and n_occ (C,) is
// the last entry. The origin is read with row stride 3, or 0 for one
// origin expanded to every ray (the trackers'), as it is.
// K9b place: one warp per ray, its cdf row staged in shared memory; per
// sample m the stratified quantile q = ((m + u) / M) * n_occ, in JAX's
// order; j = the number of cdf entries below q, found by binary search
// (the cdf is non-decreasing, so the lower bound equals JAX's
// compare-count), clipped to S - 1; frac = clip(q - (cdf_j - 1), 0, 1),
// z = (j + frac) * cstep; the fine cell floor((o + d z) / vs) is looked up
// in grid_active, and valid = n_occ > 0 & aid >= 0 & z <= t_cap. Invalid
// samples get z = 0 and aid = -1.
//
// Bound on the H100: K9a reads one 4-byte grid_active cell per slot within
// range (the 19.9 MB grid stays in the 50 MB L2) and writes the (R, S) f32
// cdf; K9b reads each cdf row once and one grid cell per sample and writes
// z, aid, valid. Both are bound by those bytes (~0.3-0.9 us at the
// trackers' 2048 rays); the arithmetic is a few dozen operations per slot
// or sample. What they take is a launch's own start and end and, within
// a ray, chains of dependent loads: K9a's four loads of a group are in
// flight together, K9b's two searches' grid reads. So the launch and the
// wrapper's host work weigh more than the device time: the wrappers
// convert and copy nothing (rays_o may be one origin broadcast with row
// stride 0), and what stays fixed over a loop (map, cdf, t_cap, outputs)
// is checked and packed into PlaceArgs once, when the placer is made and
// marches, so an iteration's call passes seven arguments. BA's rays are a subset of its step's superset, drawn anew
// each iteration: ``rows`` gives each ray its cdf row in the superset, so
// the cdf, n_occ and t_cap are neither gathered nor checked per
// iteration.
//
// Rounding: every product, sum and division that feeds a floor() or the
// quantile is written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn
// (and the library is built with -fmad=false), so cells, counts and depths
// agree exactly with the plain torch versions.

#include <cuda_runtime.h>

#include <cstddef>

// K9b's arguments that stay fixed over a loop (a tracker frame, a BA
// step), and K9a's: filled once by the wrapper; _PlaceArgs in
// nerfloam_tpu_torch/ops/raycast.py has the same fields in the same order,
// which the wrapper checks against nl_place_args_layout when it first
// launches. K9a marches the C rays of t_cap into cdf and n_occ.
struct PlaceArgs {
  const int* grid_active;
  const int* rmin;
  int Dx, Dy, Dz;
  float* cdf;
  float* n_occ;
  const float* t_cap;
  int C, R, S, M;
  float cstep, vs;
  float* z;
  int* aid;
  unsigned char* valid;
  unsigned char* ray_mask;
};

namespace {

constexpr int kMarchWarps = 4;         // K9a: rays per block
constexpr int kMarchRounds = 4;        // K9a: rounds of 32 slots whose loads a lane issues together
constexpr int kPlaceWarps = 4;         // K9b: rays per block
constexpr int kPlaceMaxSlots = 3072;   // K9b: 4 cdf rows fill 48 KB of shared memory

// the flat grid index of the cell of o + d t, or -1 outside the region
__device__ __forceinline__ int grid_index(const float* o, const float* d, float t, float vs,
                                          const int* rmin, int Dx, int Dy, int Dz) {
  int c[3];
  for (int a = 0; a < 3; ++a)
    c[a] = (int)floorf(__fdiv_rn(__fadd_rn(o[a], __fmul_rn(d[a], t)), vs)) - rmin[a];
  if (c[0] < 0 || c[0] >= Dx || c[1] < 0 || c[1] >= Dy || c[2] < 0 || c[2] >= Dz) return -1;
  return (c[0] * Dy + c[1]) * Dz + c[2];
}

__device__ __forceinline__ int grid_read(const int* grid, const float* o, const float* d, float t,
                                         float vs, const int* rmin, int Dx, int Dy, int Dz) {
  const int i = grid_index(o, d, t, vs, rmin, Dx, Dy, Dz);
  return i < 0 ? -1 : grid[i];
}

__global__ void __launch_bounds__(32 * kMarchWarps)
    march_occupancy_kernel(const PlaceArgs a, const float* __restrict__ rays_o, int o_stride,
                           const float* __restrict__ rays_d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kMarchWarps + (threadIdx.x >> 5);
  if (r >= a.C) return;  // whole warps leave
  const int S = a.S;
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = rays_o[(size_t)r * o_stride + k];
    d[k] = rays_d[3 * r + k];
  }
  const float tcap = a.t_cap[r];
  const int rm[3] = {a.rmin[0], a.rmin[1], a.rmin[2]};
  const unsigned le = 0xffffffffu >> (31 - lane);  // lanes 0..lane
  float* row = a.cdf + (size_t)r * S;
  int run = 0;
  for (int base = 0; base < S; base += 32 * kMarchRounds) {
    // the group's cells first, then its loads, all in flight together
    int cell[kMarchRounds], lid[kMarchRounds];
#pragma unroll
    for (int k = 0; k < kMarchRounds; ++k) {
      const int s = base + 32 * k + lane;
      cell[k] = -1;
      if (s < S) {
        const float tc = __fmul_rn(__fadd_rn((float)s, 0.5f), a.cstep);
        if (tc <= tcap) cell[k] = grid_index(o, d, tc, a.vs, rm, a.Dx, a.Dy, a.Dz);
      }
    }
#pragma unroll
    for (int k = 0; k < kMarchRounds; ++k) lid[k] = cell[k] >= 0 ? __ldg(a.grid_active + cell[k]) : -1;
#pragma unroll
    for (int k = 0; k < kMarchRounds; ++k) {
      if (base + 32 * k >= S) break;  // the same for the whole warp
      const int s = base + 32 * k + lane;
      const unsigned ballot = __ballot_sync(0xffffffffu, lid[k] >= 0);
      if (s < S) row[s] = (float)(run + __popc(ballot & le));
      run += __popc(ballot);
    }
  }
  if (lane == 0) a.n_occ[r] = (float)run;
}

// K9b: one warp per ray, kPlaceWarps rays per block. The warp copies its
// ray's cdf row into shared memory with coalesced loads and reads n_occ,
// t_cap, the origin (row stride o_stride: 3, or 0 for one origin
// broadcast to every ray) and the direction once; lane l then places samples
// m = l, l + 32, ... by a binary search in shared memory, with the
// arithmetic of the thread-per-sample version it replaced, so z is
// bit for bit what that gave. Lane 0 writes ray_mask. The launch ends a
// tracker's K9b call, so its device time is not hidden behind host work.
// kRows: ray r reads row rows[r] of the C rows (BA), where a row outside
// [0, C) reads nothing and its ray misses; else row r (the trackers),
// with no index load and no range test on their path.
template <bool kRows>
__global__ void __launch_bounds__(32 * kPlaceWarps)
    place_samples_kernel(const int* __restrict__ grid_active, const int* __restrict__ rmin,
                         int Dx, int Dy, int Dz, const float* __restrict__ cdf,
                         const float* __restrict__ n_occ, const float* __restrict__ t_cap, int C,
                         const int* __restrict__ rows, const float* __restrict__ rays_o,
                         int o_stride, const float* __restrict__ rays_d,
                         const float* __restrict__ u, int R,
                         int S, int M, float cstep, float vs, float* __restrict__ z_out,
                         int* __restrict__ aid_out, unsigned char* __restrict__ valid_out,
                         unsigned char* __restrict__ ray_mask) {
  extern __shared__ float staged[];  // kPlaceWarps cdf rows
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kPlaceWarps + w;
  if (r >= R) return;  // whole warps leave; the block never synchronises
  // the loads that wait on nothing are issued before the row is staged,
  // so their latencies overlap
  int c = r;
  bool known = true;
  if (kRows) {
    c = rows[r];
    known = c >= 0 && c < C;
    if (!known) c = 0;
  }
  const float n = known ? n_occ[c] : 0.0f;
  const float tcap = known ? t_cap[c] : 0.0f;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[(size_t)r * o_stride + a];
    d[a] = rays_d[3 * r + a];
  }
  const int rm[3] = {rmin[0], rmin[1], rmin[2]};
  const float* ur = u + (size_t)r * M;
  float uq[2];  // this pass's two jitters, loaded one pass ahead
#pragma unroll
  for (int k = 0; k < 2; ++k) uq[k] = lane + 32 * k < M ? ur[lane + 32 * k] : 0.0f;
  float* row = staged + (size_t)w * S;
  const float* src = cdf + (size_t)c * S;
  for (int s = lane; s < S; s += 32) row[s] = known ? src[s] : 0.0f;
  __syncwarp();
  const bool hit = n > 0.0f;
  if (lane == 0) ray_mask[r] = hit;
  // two samples per pass (m and m + 32): both searches first, then both
  // grid reads, so the two dependent loads are in flight together
  for (int m0 = lane; m0 < M; m0 += 64) {
    float z[2] = {0.0f, 0.0f}, un[2];
    int aid[2] = {-1, -1};
#pragma unroll
    for (int k = 0; k < 2; ++k) un[k] = m0 + 64 + 32 * k < M ? ur[m0 + 64 + 32 * k] : 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int m = m0 + 32 * k;
      if (m >= M) break;
      float q = __fmul_rn(__fdiv_rn(__fadd_rn((float)m, uq[k]), (float)M), n);
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
      z[k] = __fmul_rn(__fadd_rn((float)j, frac), cstep);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (m0 + 32 * k < M) aid[k] = grid_read(grid_active, o, d, z[k], vs, rm, Dx, Dy, Dz);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int m = m0 + 32 * k;
      if (m >= M) break;
      const size_t i = (size_t)r * M + m;
      bool valid = hit && aid[k] >= 0 && z[k] <= tcap;
      z_out[i] = valid ? z[k] : 0.0f;
      aid_out[i] = valid ? aid[k] : -1;
      valid_out[i] = valid;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) uq[k] = un[k];
  }
}

}  // namespace

// K9a over the C rays of a->t_cap; rays_o rows are o_stride floats apart
// (3, or 0 for one shared origin).
extern "C" int nl_march_occupancy(const PlaceArgs* a, const float* rays_o, int o_stride,
                                  const float* rays_d, void* stream) {
  if (a->C > 0)
    march_occupancy_kernel<<<(a->C + kMarchWarps - 1) / kMarchWarps, 32 * kMarchWarps, 0,
                             (cudaStream_t)stream>>>(*a, rays_o, o_stride, rays_d);
  return (int)cudaGetLastError();
}

extern "C" int nl_place_max_slots() { return kPlaceMaxSlots; }

// sizeof(PlaceArgs), then the offset of each field in declaration order;
// returns the number of entries written (out holds 32).
extern "C" int nl_place_args_layout(int* out) {
  int n = 0;
#define NL_AT(f) out[n++] = (int)offsetof(PlaceArgs, f)
  out[n++] = (int)sizeof(PlaceArgs);
  NL_AT(grid_active); NL_AT(rmin); NL_AT(Dx); NL_AT(Dy); NL_AT(Dz); NL_AT(cdf); NL_AT(n_occ);
  NL_AT(t_cap); NL_AT(C); NL_AT(R); NL_AT(S); NL_AT(M); NL_AT(cstep); NL_AT(vs); NL_AT(z);
  NL_AT(aid); NL_AT(valid); NL_AT(ray_mask);
#undef NL_AT
  return n;
}

// rows: (R,) cdf row of each ray, or null for row r; rays_o rows are
// o_stride floats apart (3, or 0 for one shared origin).
extern "C" int nl_place_samples_cdf(const PlaceArgs* a, const int* rows, const float* rays_o,
                                    int o_stride, const float* rays_d, const float* u,
                                    void* stream) {
  if (a->S > kPlaceMaxSlots) return (int)cudaErrorInvalidValue;
  if (a->R > 0 && a->M > 0 && a->S > 0) {
    auto kernel = rows ? place_samples_kernel<true> : place_samples_kernel<false>;
    kernel<<<(a->R + kPlaceWarps - 1) / kPlaceWarps, 32 * kPlaceWarps,
             kPlaceWarps * a->S * sizeof(float), (cudaStream_t)stream>>>(
        a->grid_active, a->rmin, a->Dx, a->Dy, a->Dz, a->cdf, a->n_occ, a->t_cap, a->C, rows,
        rays_o, o_stride, rays_d, u, a->R, a->S, a->M, a->cstep, a->vs, a->z, a->aid, a->valid,
        a->ray_mask);
  }
  return (int)cudaGetLastError();
}
