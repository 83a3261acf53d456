// K7: voxel insert (port of nerfloam_tpu/map/voxel_map.py:311-449
// insert_points, as driven by insert_frame 535-575 with support points).
//
// Five passes, each one thread per point or per (candidate, corner) slot;
// the wrapper (map/voxel_map.py insert_points) runs the prefix sums between
// them with torch.cumsum:
//   elect      cell of every point, floor(p / vs); in-region valid points
//              elect their cell's representative by atomicMin of the point
//              slot into a grid-sized scratch (the smallest slot wins).
//   candidate  a point is a new-voxel candidate when it won its cell and
//              the cell is not already a surface voxel.
//   corners    (after cumsum of the candidates) candidates are compacted
//              to cand_cap rows; each of their 8 corners that is in region
//              and not allocated elects its cell by atomicMin of the corner
//              slot into a second grid-sized scratch.
//   alloc      (after cumsum of the elected corners) each elected corner
//              takes row num_lat + rank, if it fits the capacity, and is
//              written to lat_coords and grid.
//   activate   each candidate looks its 8 corners up in the updated grid;
//              a complete corner set makes the voxel surface and sets its
//              corner_idx.
//   append     (after cumsum of the activated voxels, lazy recentering)
//              activated voxels are appended to the active set with their
//              packed rows of 8 corner embeddings.
// JAX leaves the election winner unspecified; electing the smallest slot
// makes this kernel and its plain torch twin agree exactly on every table.
//
// Bound on the H100: at the quality config 196,608 points and two
// 288*288*60 int32 election grids (19.9 MB each, filled by the wrapper):
// a few random 4-byte reads per point and per corner into grids that stay
// in the 50 MB L2, and the packed rows (512 B) of the appended voxels. The
// kernel is memory-bound on those scattered reads; the table copies the
// wrapper makes (functions return a new MapState) move more bytes than
// the passes themselves.
//
// Rounding: floor(p / vs) uses __fdiv_rn (and -fmad=false), the IEEE
// division the plain version takes, so both see the same cells.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int flat_cell(int x, int y, int z, const int* rmin, int Dx, int Dy,
                                         int Dz) {
  x -= rmin[0];
  y -= rmin[1];
  z -= rmin[2];
  if (x < 0 || x >= Dx || y < 0 || y >= Dy || z < 0 || z >= Dz) return -1;
  return (x * Dy + y) * Dz + z;
}

__global__ void elect_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                             int P, float vs, const int* __restrict__ rmin, int Dx, int Dy,
                             int Dz, int* __restrict__ winner, int* __restrict__ vox,
                             int* __restrict__ vflat) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  int c[3];
  for (int a = 0; a < 3; ++a) {
    c[a] = (int)floorf(__fdiv_rn(pts[3 * i + a], vs));
    vox[3 * i + a] = c[a];
  }
  int f = valid[i] ? flat_cell(c[0], c[1], c[2], rmin, Dx, Dy, Dz) : -1;
  vflat[i] = f;
  if (f >= 0) atomicMin(winner + f, i);
}

__global__ void candidate_kernel(const int* __restrict__ vflat, const int* __restrict__ winner,
                                 const int* __restrict__ grid,
                                 const unsigned char* __restrict__ is_surface, int P,
                                 int* __restrict__ cand) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  int f = vflat[i];
  int c = 0;
  if (f >= 0 && winner[f] == i) {
    int lid = grid[f];
    c = !(lid >= 0 && is_surface[lid]);
  }
  cand[i] = c;
}

// one thread per (point, corner); the candidate of rank k owns slots 8k..8k+7
__global__ void corners_kernel(const int* __restrict__ vox, const int* __restrict__ cand,
                               const int* __restrict__ crank, int P, int Pc,
                               const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                               const int* __restrict__ grid, int* __restrict__ cwinner,
                               int* __restrict__ vox_c, unsigned char* __restrict__ cand_c,
                               int* __restrict__ cflat) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 8 * P) return;
  int i = t >> 3, j = t & 7;
  if (!cand[i]) return;
  int k = crank[i] - 1;
  if (k >= Pc) return;
  int s = 8 * k + j;
  int c0 = vox[3 * i] + ((j >> 2) & 1), c1 = vox[3 * i + 1] + ((j >> 1) & 1),
      c2 = vox[3 * i + 2] + (j & 1);
  if (j == 0) {
    vox_c[3 * k] = vox[3 * i];
    vox_c[3 * k + 1] = vox[3 * i + 1];
    vox_c[3 * k + 2] = vox[3 * i + 2];
    cand_c[k] = 1;
  }
  int f = flat_cell(c0, c1, c2, rmin, Dx, Dy, Dz);
  if (f >= 0 && grid[f] < 0) {
    cflat[s] = f;
    atomicMin(cwinner + f, s);
  }
}

__global__ void corner_new_kernel(const int* __restrict__ cflat, const int* __restrict__ cwinner,
                                  int n, int* __restrict__ cnew) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  int f = cflat[s];
  cnew[s] = f >= 0 && cwinner[f] == s;
}

__global__ void alloc_kernel(const int* __restrict__ vox_c, const int* __restrict__ cflat,
                             const int* __restrict__ cnew, const int* __restrict__ rank, int n,
                             const int* __restrict__ num_lat, int C,
                             int* __restrict__ lat_coords, int* __restrict__ grid) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n || !cnew[s]) return;
  int id = num_lat[0] + rank[s] - 1;
  if (id >= C) return;
  int k = s >> 3, j = s & 7;
  lat_coords[3 * id] = vox_c[3 * k] + ((j >> 2) & 1);
  lat_coords[3 * id + 1] = vox_c[3 * k + 1] + ((j >> 1) & 1);
  lat_coords[3 * id + 2] = vox_c[3 * k + 2] + (j & 1);
  grid[cflat[s]] = id;
}

__global__ void activate_kernel(const int* __restrict__ vox_c,
                                const unsigned char* __restrict__ cand_c, int Pc,
                                const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                                const int* __restrict__ grid, unsigned char* __restrict__ is_surface,
                                int* __restrict__ corner_idx, int* __restrict__ clid,
                                int* __restrict__ act) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= Pc) return;
  int ids[8];
  bool complete = true;
  for (int j = 0; j < 8; ++j) {
    int f = flat_cell(vox_c[3 * k] + ((j >> 2) & 1), vox_c[3 * k + 1] + ((j >> 1) & 1),
                      vox_c[3 * k + 2] + (j & 1), rmin, Dx, Dy, Dz);
    ids[j] = f >= 0 ? grid[f] : -1;
    complete = complete && ids[j] >= 0;
    clid[8 * k + j] = ids[j];
  }
  bool a = cand_c[k] && complete;
  act[k] = a;
  if (a) {
    is_surface[ids[0]] = 1;
    for (int j = 0; j < 8; ++j) corner_idx[8 * ids[0] + j] = ids[j];
  }
}

__device__ __forceinline__ float emb_at(const void* emb, int bf16, size_t i) {
  if (bf16) {
    unsigned int bits = static_cast<const unsigned short*>(emb)[i];
    return __uint_as_float(bits << 16);
  }
  return static_cast<const float*>(emb)[i];
}

// one thread per (candidate, packed float): the row of 8 corners x F features
__global__ void append_kernel(const int* __restrict__ vox_c, const int* __restrict__ act,
                              const int* __restrict__ arank, const int* __restrict__ clid,
                              int Pc, const int* __restrict__ n_active, int A,
                              const int* __restrict__ rmin, int Dx, int Dy, int Dz,
                              const void* __restrict__ emb, int bf16, int F,
                              int* __restrict__ active_ids, int* __restrict__ active_coords,
                              int* __restrict__ grid_active, float* __restrict__ packed) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int row = 8 * F;
  if (t >= (long long)Pc * row) return;
  int k = (int)(t / row), e = (int)(t - (long long)k * row);
  if (!act[k]) return;
  int pos = n_active[0] + arank[k] - 1;
  if (pos >= A) return;
  int j = e / F, f = e - j * F;
  packed[(size_t)pos * row + e] = emb_at(emb, bf16, (size_t)clid[8 * k + j] * F + f);
  if (e == 0) {
    active_ids[pos] = clid[8 * k];
    for (int a = 0; a < 3; ++a) active_coords[3 * pos + a] = vox_c[3 * k + a];
    grid_active[flat_cell(vox_c[3 * k], vox_c[3 * k + 1], vox_c[3 * k + 2], rmin, Dx, Dy, Dz)] =
        pos;
  }
}

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int nl_insert_elect(const float* pts, const unsigned char* valid, int P, float vs,
                               const int* rmin, int Dx, int Dy, int Dz, int* winner, int* vox,
                               int* vflat, void* stream) {
  if (P > 0)
    elect_kernel<<<blocks(P), kThreads, 0, (cudaStream_t)stream>>>(pts, valid, P, vs, rmin, Dx,
                                                                   Dy, Dz, winner, vox, vflat);
  return (int)cudaGetLastError();
}

extern "C" int nl_insert_candidate(const int* vflat, const int* winner, const int* grid,
                                   const unsigned char* is_surface, int P, int* cand,
                                   void* stream) {
  if (P > 0)
    candidate_kernel<<<blocks(P), kThreads, 0, (cudaStream_t)stream>>>(vflat, winner, grid,
                                                                       is_surface, P, cand);
  return (int)cudaGetLastError();
}

extern "C" int nl_insert_corners(const int* vox, const int* cand, const int* crank, int P, int Pc,
                                 const int* rmin, int Dx, int Dy, int Dz, const int* grid,
                                 int* cwinner, int* vox_c, unsigned char* cand_c, int* cflat,
                                 void* stream) {
  if (P > 0)
    corners_kernel<<<blocks(8LL * P), kThreads, 0, (cudaStream_t)stream>>>(
        vox, cand, crank, P, Pc, rmin, Dx, Dy, Dz, grid, cwinner, vox_c, cand_c, cflat);
  return (int)cudaGetLastError();
}

extern "C" int nl_insert_corner_new(const int* cflat, const int* cwinner, int n, int* cnew,
                                    void* stream) {
  if (n > 0)
    corner_new_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(cflat, cwinner, n, cnew);
  return (int)cudaGetLastError();
}

extern "C" int nl_insert_alloc(const int* vox_c, const int* cflat, const int* cnew,
                               const int* rank, int n, const int* num_lat, int C,
                               int* lat_coords, int* grid, void* stream) {
  if (n > 0)
    alloc_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(vox_c, cflat, cnew, rank, n,
                                                                   num_lat, C, lat_coords, grid);
  return (int)cudaGetLastError();
}

extern "C" int nl_insert_activate(const int* vox_c, const unsigned char* cand_c, int Pc,
                                  const int* rmin, int Dx, int Dy, int Dz, const int* grid,
                                  unsigned char* is_surface, int* corner_idx, int* clid,
                                  int* act, void* stream) {
  if (Pc > 0)
    activate_kernel<<<blocks(Pc), kThreads, 0, (cudaStream_t)stream>>>(
        vox_c, cand_c, Pc, rmin, Dx, Dy, Dz, grid, is_surface, corner_idx, clid, act);
  return (int)cudaGetLastError();
}

extern "C" int nl_insert_append(const int* vox_c, const int* act, const int* arank,
                                const int* clid, int Pc, const int* n_active, int A,
                                const int* rmin, int Dx, int Dy, int Dz, const void* emb,
                                int bf16, int F, int* active_ids, int* active_coords,
                                int* grid_active, float* packed, void* stream) {
  if (Pc > 0)
    append_kernel<<<blocks((long long)Pc * 8 * F), kThreads, 0, (cudaStream_t)stream>>>(
        vox_c, act, arank, clid, Pc, n_active, A, rmin, Dx, Dy, Dz, emb, bf16, F, active_ids,
        active_coords, grid_active, packed);
  return (int)cudaGetLastError();
}
