// K4: per-ray hit table (port of nerfloam_tpu/ops/raycast.py:159-220
// build_hit_table, with map/voxel_map.py:172-181 lookup_active inlined).
//
// A probe at t_c = (s + 0.5) * cstep counts while t_c <= t_cap + cstep;
// its cell floor((o + d t_c) / vs) is looked up in grid_active (-1 outside
// the region); a hit is a probe whose active id is >= 0 and differs from
// the previous probe's. The first H hits are kept, each gets the exact
// slab test against its cell (re-derived from the probe point), and the
// ray's inclusive cdf of segment lengths is summed in ascending order.
//
// One warp per ray, kWarps rays per block:
//   march   lane l takes probes s = l + 32 j, one round of 32 at a time,
//           so a round's grid reads are all in flight together. t_c grows
//           with s, so a probe past the range is masked (the sequential
//           walk's break); the previous probe's id comes from the lane
//           below (__shfl_up_sync; lane 0 takes the previous round's lane
//           31, -2 before the first). __ballot_sync / __popc give each hit
//           its slot; the first H go to the warp's shared table. The walk
//           stops once a round reaches past the range or H hits are held.
//   slab    lane h (and h + 32 when H > 32) computes its hit's cell, t_near
//           and segment; padding entries take slot 0, as the JAX table.
//   cdf     lane h adds seg[0..h] from shared memory in ascending order
//           from 0.0f, rounding after every add: the bits of a sequential
//           running sum (a scan tree would round differently).
//   store   the warp writes each of the ray's table rows as one contiguous
//           run; the packed form writes BA's (R, 7H) f32 row [aid, t_near,
//           seg, cdf, cell xyz] instead (pack_hit_table's layout).
// The origin is read with its row stride: 3, or 0 for one origin shared by
// every ray (the tracker's form), so the wrapper copies nothing.
//
// Bound on the H100: the probes each ray needs, one random 4-byte read
// each into grid_active (288*288*60 int32 = 19.9 MB at the bench shapes,
// resident in the 50 MB L2), the rays in and 28 bytes per table slot out.
// At 2048-4096 rays a warp per ray gives 256-512 blocks of 8 warps over
// the 132 SMs (a thread per ray gave 16-32 blocks of 128 threads).
//
// Rounding: every product and sum that feeds a floor() is written with
// __fmul_rn / __fadd_rn / __fdiv_rn (and the library is built with
// -fmad=false), so no FMA contraction or approximate division moves a
// probe across a voxel face; the plain torch version gets the same cells.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxHits = 64;
constexpr int kWarps = 8;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

struct RayTable {  // one warp's ray, in shared memory
  int slot[kMaxHits];
  int aid[kMaxHits];
  float t_near[kMaxHits];
  float seg[kMaxHits];
  float cdf[kMaxHits];
  int cell[3 * kMaxHits];
};

__device__ __forceinline__ int probe_cell(const float* o, const float* d, float t, int a,
                                          float vs) {
  return (int)floorf(__fdiv_rn(__fadd_rn(o[a], __fmul_rn(d[a], t)), vs));
}

template <bool kPacked>
__global__ void __launch_bounds__(32 * kWarps) hit_table_warp_kernel(
    const int* __restrict__ grid_active, const int* __restrict__ region_min, int Dx, int Dy,
    int Dz, const float* __restrict__ rays_o, int o_stride, const float* __restrict__ rays_d,
    const float* __restrict__ t_cap, int R, int S, int H, float cstep, float vs,
    int* __restrict__ aid, float* __restrict__ t_near, float* __restrict__ seg,
    float* __restrict__ cdf, int* __restrict__ cell, unsigned char* __restrict__ ray_mask,
    float* __restrict__ packed) {
  __shared__ RayTable s_tab[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp
  RayTable& tab = s_tab[warp];
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[o_stride * r + a];
    d[a] = rays_d[3 * r + a];
  }
  const float tcap = t_cap[r];
  const float tlim = __fadd_rn(tcap, cstep);
  const int rx = region_min[0], ry = region_min[1], rz = region_min[2];

  int n = 0, carry = -2;
  for (int base = 0; base < S; base += 32) {
    const int s = base + lane;
    const float tc = __fmul_rn(__fadd_rn((float)s, 0.5f), cstep);
    const bool in = s < S && tc <= tlim;
    int id = -1;
    if (in) {
      const int x = probe_cell(o, d, tc, 0, vs) - rx, y = probe_cell(o, d, tc, 1, vs) - ry,
                z = probe_cell(o, d, tc, 2, vs) - rz;
      if (x >= 0 && x < Dx && y >= 0 && y < Dy && z >= 0 && z < Dz)
        id = grid_active[(x * Dy + y) * Dz + z];
    }
    int prev = __shfl_up_sync(kFull, id, 1);
    if (lane == 0) prev = carry;
    const bool hit = id >= 0 && id != prev;
    const unsigned hits = __ballot_sync(kFull, hit);
    if (hit) {
      const int pos = n + __popc(hits & ((1u << lane) - 1u));
      if (pos < H) {
        tab.aid[pos] = id;
        tab.slot[pos] = s;
      }
    }
    n += __popc(hits);
    carry = __shfl_sync(kFull, id, 31);
    if (n >= H || !__all_sync(kFull, in)) break;
  }
  __syncwarp();
  const int nh = n < H ? n : H;

  float inv_d[3];
  for (int a = 0; a < 3; ++a)
    inv_d[a] = __fdiv_rn(1.0f, fabsf(d[a]) < 1e-9f ? 1e-9f : d[a]);
  for (int h = lane; h < H; h += 32) {
    const int a_h = h < nh ? tab.aid[h] : -1;
    const int s = h < nh ? tab.slot[h] : 0;  // padding entries take slot 0
    const float ht = __fmul_rn(__fadd_rn((float)s, 0.5f), cstep);
    float tn = -CUDART_INF_F, tf = CUDART_INF_F;
    for (int a = 0; a < 3; ++a) {
      const float hc = floorf(__fdiv_rn(__fadd_rn(o[a], __fmul_rn(d[a], ht)), vs));
      tab.cell[3 * h + a] = (int)hc;
      const float vmin = __fmul_rn(hc, vs);
      const float vmax = __fadd_rn(vmin, vs);
      const float t0 = __fmul_rn(__fsub_rn(vmin, o[a]), inv_d[a]);
      const float t1 = __fmul_rn(__fsub_rn(vmax, o[a]), inv_d[a]);
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    tn = fmaxf(tn, 0.0f);
    tf = fminf(tf, tcap);
    tab.aid[h] = a_h;
    tab.t_near[h] = tn;
    tab.seg[h] = a_h >= 0 ? fmaxf(__fsub_rn(tf, tn), 0.0f) : 0.0f;
  }
  __syncwarp();
  for (int h = lane; h < H; h += 32) {
    float acc = 0.0f;
    for (int j = 0; j <= h; ++j) acc = __fadd_rn(acc, tab.seg[j]);
    tab.cdf[h] = acc;
  }
  __syncwarp();

  if (kPacked) {
    float* row = packed + (size_t)r * 7 * H;
    for (int e = lane; e < 7 * H; e += 32) {
      const int q = e / H, h = e - q * H;
      float v;
      if (q == 0)
        v = (float)tab.aid[h];
      else if (q == 1)
        v = tab.t_near[h];
      else if (q == 2)
        v = tab.seg[h];
      else if (q == 3)
        v = tab.cdf[h];
      else
        v = (float)tab.cell[e - 4 * H];
      row[e] = v;
    }
  } else {
    const size_t at = (size_t)r * H;
    for (int h = lane; h < H; h += 32) {
      aid[at + h] = tab.aid[h];
      t_near[at + h] = tab.t_near[h];
      seg[at + h] = tab.seg[h];
      cdf[at + h] = tab.cdf[h];
    }
    for (int e = lane; e < 3 * H; e += 32) cell[3 * at + e] = tab.cell[e];
    if (lane == 0) ray_mask[r] = tab.cdf[H - 1] > 0.0f;
  }
}

}  // namespace

extern "C" int nl_hit_table_max_hits() { return kMaxHits; }

// packed null: the six tables; packed given: BA's (R, 7H) rows alone
// (aid ... ray_mask ignored). o_stride: 3, or 0 for one shared origin.
extern "C" int nl_hit_table(const int* grid_active, const int* region_min, int Dx, int Dy,
                            int Dz, const float* rays_o, int o_stride, const float* rays_d,
                            const float* t_cap, int R, int S, int H, float cstep, float vs,
                            int* aid, float* t_near, float* seg, float* cdf, int* cell,
                            unsigned char* ray_mask, float* packed, void* stream) {
  if (R > 0) {
    const int blocks = (R + kWarps - 1) / kWarps;
    cudaStream_t s = (cudaStream_t)stream;
    if (packed != nullptr)
      hit_table_warp_kernel<true><<<blocks, 32 * kWarps, 0, s>>>(
          grid_active, region_min, Dx, Dy, Dz, rays_o, o_stride, rays_d, t_cap, R, S, H, cstep,
          vs, aid, t_near, seg, cdf, cell, ray_mask, packed);
    else
      hit_table_warp_kernel<false><<<blocks, 32 * kWarps, 0, s>>>(
          grid_active, region_min, Dx, Dy, Dz, rays_o, o_stride, rays_d, t_cap, R, S, H, cstep,
          vs, aid, t_near, seg, cdf, cell, ray_mask, packed);
  }
  return (int)cudaGetLastError();
}
