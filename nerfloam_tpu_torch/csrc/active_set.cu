// K6: the region grid and the active set (port of
// nerfloam_tpu/map/voxel_map.py:149-169 recenter and 183-225
// refresh_active, as driven by recenter_refresh / maybe_recenter_refresh
// 513-532), plus the packed-row gather that K5 (csrc/reconcile.cu) reuses
// for pack_embeddings (301-308).
//
// recenter, two passes, one thread per cell or per lattice row:
//   fill      grid[cell] = -1 over the whole region grid
//   scatter   grid[flat(lat_coords[i] - region_min)] = i for every row
//             i < num_lat inside the region. Each lattice row has its own
//             coords, so destinations are distinct and no atomics are needed.
// refresh_active, three passes; the wrapper runs the inclusive prefix sum
// of the marks with torch.cumsum between the first two:
//   mark      act[i] = in region & is_surface & i < num_lat, and the fresh
//             grid_active (-1) and active_ids (0) are filled in the same
//             launch (grid-stride over the largest of the three sizes)
//   place     an active row of rank r < A writes active_ids[r] = i and
//             grid_active[flat] = r: the active order is ascending lattice
//             id, exactly the order of JAX's cumsum
//   pack      a warp per active row, a float4 per lane: the row's 8 corner
//             embeddings as f32 (A, 8F), and active_coords[a] =
//             lat_coords[active_ids[a]] (padding rows read row 0, as in JAX)
// The true count n_active (it may exceed A) is the prefix sum's last entry.
//
// Bound on the H100: at the bench shapes C = 2,097,152 rows, a 288x288x60
// int32 grid (19.9 MB) and A = 73,728-131,072 active rows. recenter reads
// lat_coords (25 MB) and writes the grid; refresh reads lat_coords and
// is_surface, writes the grid again, and gathers 8 embedding rows per
// active voxel into the (A, 128) f32 table (37.7-67.1 MB written). All
// memory-bound streaming plus one gather per 16 bytes of a packed row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPackWarps = 8;  // packed rows per block

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ int flat_cell(const int* c, const int* rmin, int Dx, int Dy, int Dz) {
  int x = c[0] - rmin[0], y = c[1] - rmin[1], z = c[2] - rmin[2];
  if (x < 0 || x >= Dx || y < 0 || y >= Dy || z < 0 || z >= Dz) return -1;
  return (x * Dy + y) * Dz + z;
}

__global__ void grid_fill_kernel(int* __restrict__ out, long long n, int value) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) out[t] = value;
}

__global__ void recenter_kernel(const int* __restrict__ lat_coords,
                                const int* __restrict__ num_lat, int C,
                                const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                                int* __restrict__ grid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C || i >= num_lat[0]) return;
  int f = flat_cell(lat_coords + 3 * i, rmin, Dx, Dy, Dz);
  if (f >= 0) grid[f] = i;
}

__global__ void refresh_mark_kernel(const int* __restrict__ lat_coords,
                                    const unsigned char* __restrict__ is_surface,
                                    const int* __restrict__ num_lat, int C,
                                    const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                                    long long total, int A, int* __restrict__ act,
                                    int* __restrict__ grid_active, int* __restrict__ active_ids) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) grid_active[t] = -1;
  if (t < A) active_ids[t] = 0;
  if (t < C) {
    int i = (int)t;
    act[i] = i < num_lat[0] && is_surface[i] &&
             flat_cell(lat_coords + 3 * i, rmin, Dx, Dy, Dz) >= 0;
  }
}

__global__ void refresh_place_kernel(const int* __restrict__ lat_coords,
                                     const int* __restrict__ act, const int* __restrict__ rank,
                                     int C, const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                                     int A, int* __restrict__ grid_active,
                                     int* __restrict__ active_ids) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C || !act[i]) return;
  int r = rank[i] - 1;
  if (r >= A) return;
  active_ids[r] = i;
  grid_active[flat_cell(lat_coords + 3 * i, rmin, Dx, Dy, Dz)] = r;
}

// A warp per active row a, one float4 of the packed row per lane: the
// row's active id is read once for the warp, each corner id once for the
// lanes of its corner (one load), the embedding 16 bytes (f32) or 8 bytes
// (four bf16, widened) at a time, and the row goes out as 16-byte stores.
// A copy and a widening: bit-identical to the plain gather. 32-bit index
// math (the wrappers check A * 8F < 2^31 and F % 4 == 0).
__global__ void __launch_bounds__(32 * kPackWarps) active_pack_rows_kernel(
    const int* __restrict__ active_ids, const int* __restrict__ corner_idx,
    const void* __restrict__ emb, int bf16, int A, int F, const int* __restrict__ lat_coords,
    float* __restrict__ packed, int* __restrict__ active_coords) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (a >= A) return;
  const int id = active_ids[a];
  const int q4 = F >> 2;   // float4s per corner
  const int nq = 8 * q4;   // float4s per packed row
  float4* out = reinterpret_cast<float4*>(packed) + a * nq;
  for (int q = lane; q < nq; q += 32) {
    const int j = q / q4, f4 = q - j * q4;
    const int c = max(corner_idx[8 * id + j], 0);  // padding corners read row 0, as in JAX
    float4 v;
    if (bf16) {
      const uint2 b = reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(emb) +
                                                     (size_t)c * F)[f4];
      v = make_float4(__uint_as_float(b.x << 16), __uint_as_float(b.x & 0xffff0000u),
                      __uint_as_float(b.y << 16), __uint_as_float(b.y & 0xffff0000u));
    } else {
      v = reinterpret_cast<const float4*>(static_cast<const float*>(emb) + (size_t)c * F)[f4];
    }
    out[q] = v;
  }
  if (active_coords != nullptr && lane < 3) active_coords[3 * a + lane] = lat_coords[3 * id + lane];
}

}  // namespace

extern "C" int nl_recenter(const int* lat_coords, const int* num_lat, int C, const int* rmin,
                           int Dx, int Dy, int Dz, int* grid, void* stream) {
  long long total = (long long)Dx * Dy * Dz;
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0) grid_fill_kernel<<<blocks(total), kThreads, 0, s>>>(grid, total, -1);
  if (C > 0)
    recenter_kernel<<<blocks(C), kThreads, 0, s>>>(lat_coords, num_lat, C, rmin, Dx, Dy, Dz,
                                                   grid);
  return (int)cudaGetLastError();
}

extern "C" int nl_refresh_mark(const int* lat_coords, const unsigned char* is_surface,
                               const int* num_lat, int C, const int* rmin, int Dx, int Dy, int Dz,
                               int A, int* act, int* grid_active, int* active_ids, void* stream) {
  long long total = (long long)Dx * Dy * Dz;
  long long n = total > C ? total : C;
  if (A > n) n = A;
  if (n > 0)
    refresh_mark_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        lat_coords, is_surface, num_lat, C, rmin, Dx, Dy, Dz, total, A, act, grid_active,
        active_ids);
  return (int)cudaGetLastError();
}

extern "C" int nl_refresh_place(const int* lat_coords, const int* act, const int* rank, int C,
                                const int* rmin, int Dx, int Dy, int Dz, int A, int* grid_active,
                                int* active_ids, void* stream) {
  if (C > 0)
    refresh_place_kernel<<<blocks(C), kThreads, 0, (cudaStream_t)stream>>>(
        lat_coords, act, rank, C, rmin, Dx, Dy, Dz, A, grid_active, active_ids);
  return (int)cudaGetLastError();
}

// lat_coords / active_coords null: the packed table alone (pack_embeddings)
extern "C" int nl_active_pack(const int* active_ids, const int* corner_idx, const void* emb,
                              int bf16, int A, int F, const int* lat_coords, float* packed,
                              int* active_coords, void* stream) {
  if (A > 0)
    active_pack_rows_kernel<<<(A + kPackWarps - 1) / kPackWarps, 32 * kPackWarps, 0,
                              (cudaStream_t)stream>>>(active_ids, corner_idx, emb, bf16, A, F,
                                                      lat_coords, packed, active_coords);
  return (int)cudaGetLastError();
}
