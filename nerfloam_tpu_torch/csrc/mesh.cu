// K10a and K10b: the two device passes of mesh extraction (port of
// nerfloam_tpu/map/mesher.py:59-82 _mesh_chunk and nerfloam_tpu/ops/
// marching.py:63-106 marching_tets_cells). The decoder runs between them
// in torch (a plain matrix product, as in JAX).
//
// K10a mesh_lattice: one thread per (surface voxel b, lattice sample s,
// feature f). The voxel's 8 corner rows are read through clip(cidx, 0) as
// JAX reads them, widened to f32, and summed with the sample's trilinear
// weights in corner order j = x<<2 | y<<1 | z, one rounded product and one
// rounded add per corner (no FMA), so at res 2 (weights 0 / 1) the
// features are the corner rows themselves. Threads f < 3 also write the
// sample's world position base + fr * vs.
//
// K10b marching_tets: one thread per (cell, Kuhn tetrahedron). It gathers
// the tet's 4 lattice samples through the cell-corner table, forms the
// sign case, the 6 edge zero crossings t = va / (va - vb) (clipped to
// [0, 1], the denominator replaced by 1e-12 when smaller), and writes the
// case's up to 2 triangles and their mask from tables in constant memory.
// Unused slots hold edge 0's vertex, as the JAX gather through clip(., 0)
// leaves them. Every operation is a single IEEE-rounded one in JAX's
// order, so a vertex shared by two cells or two voxels comes out bitwise
// equal from both and the host's weld merges it.
//
// Bound on the H100: both are memory-bound. K10a reads 8 rows of F
// embeddings per voxel (L2 serves the S samples' re-reads) and writes
// S * (F + 3) floats per voxel; K10b reads 4 floats per lattice sample and
// writes 12 x (36 + 1) bytes per cell, which dominates: 444 B per cell.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename Emb>
__global__ void mesh_lattice_kernel(const int* __restrict__ voxel_ids,
                                    const int* __restrict__ corner_idx,
                                    const Emb* __restrict__ emb,
                                    const int* __restrict__ lat_coords,
                                    const float* __restrict__ fr, const float* __restrict__ w,
                                    long long n, int S, int F, float vs,
                                    float* __restrict__ feats, float* __restrict__ pos) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int f = (int)(t % F);
  long long bs = t / F;
  int s = (int)(bs % S);
  long long b = bs / S;
  int v = voxel_ids[b];
  if (v < 0) v = 0;
  const int* c = corner_idx + 8LL * v;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int row = c[j] < 0 ? 0 : c[j];
    float p = __fmul_rn(w[8 * s + j], to_f(emb[(size_t)row * F + f]));
    acc = j == 0 ? p : __fadd_rn(acc, p);
  }
  feats[t] = acc;
  if (f < 3) {
    float base = __fmul_rn((float)lat_coords[3LL * v + f], vs);
    pos[bs * 3 + f] = __fadd_rn(base, __fmul_rn(fr[3 * s + f], vs));
  }
}

// ops/marching.py: TET_CORNERS, EDGE_PAIRS, TRI_TABLE
__constant__ int c_tet_corners[6][4] = {
    {0, 4, 6, 7}, {0, 4, 5, 7}, {0, 2, 6, 7}, {0, 2, 3, 7}, {0, 1, 5, 7}, {0, 1, 3, 7}};
__constant__ int c_edge_pairs[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
__constant__ int c_tri_table[16][2][3] = {
    {{-1, -1, -1}, {-1, -1, -1}}, {{0, 1, 2}, {-1, -1, -1}}, {{0, 3, 4}, {-1, -1, -1}},
    {{1, 2, 4}, {1, 4, 3}},       {{1, 5, 3}, {-1, -1, -1}}, {{0, 2, 5}, {0, 5, 3}},
    {{0, 4, 5}, {0, 5, 1}},       {{2, 4, 5}, {-1, -1, -1}}, {{2, 5, 4}, {-1, -1, -1}},
    {{0, 1, 5}, {0, 5, 4}},       {{0, 3, 5}, {0, 5, 2}},    {{1, 3, 5}, {-1, -1, -1}},
    {{1, 4, 2}, {1, 3, 4}},       {{0, 4, 3}, {-1, -1, -1}}, {{0, 2, 1}, {-1, -1, -1}},
    {{-1, -1, -1}, {-1, -1, -1}}};

__global__ void marching_tets_kernel(const float* __restrict__ sdf, const float* __restrict__ pos,
                                     const int* __restrict__ cct,
                                     const int* __restrict__ voxel_ids, long long n, int S,
                                     int ncell, float* __restrict__ tris,
                                     unsigned char* __restrict__ valid) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int tet = (int)(t % 6);
  long long cell = t / 6;
  long long b = cell / ncell;
  const int* cc = cct + 8 * (int)(cell % ncell);
  float v[4], p[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    long long lat = b * S + cc[c_tet_corners[tet][k]];
    v[k] = sdf[lat];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[k][d] = pos[lat * 3 + d];
  }
  int cs = (v[0] < 0.0f) | ((v[1] < 0.0f) << 1) | ((v[2] < 0.0f) << 2) | ((v[3] < 0.0f) << 3);
  float ev[6][3];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    int a = c_edge_pairs[e][0], c = c_edge_pairs[e][1];
    float den = __fsub_rn(v[a], v[c]);
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    float tt = __fdiv_rn(v[a], den);
    tt = tt < 0.0f ? 0.0f : (tt > 1.0f ? 1.0f : tt);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      ev[e][d] = __fadd_rn(p[a][d], __fmul_rn(tt, __fsub_rn(p[c][d], p[a][d])));
  }
  bool vox_ok = voxel_ids == nullptr || voxel_ids[b] >= 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    long long slot = cell * 12 + tet * 2 + s;
    valid[slot] = (c_tri_table[cs][s][0] >= 0) && vox_ok;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int e = c_tri_table[cs][s][k];
      if (e < 0) e = 0;
      for (int d = 0; d < 3; ++d) tris[(slot * 3 + k) * 3 + d] = ev[e][d];
    }
  }
}

}  // namespace

// feats (B, S, F) and pos (B, S, 3) for B voxel ids (-1 pads read row 0)
extern "C" int nl_mesh_lattice(const int* voxel_ids, const int* corner_idx, const void* emb,
                               int bf16, const int* lat_coords, const float* fr, const float* w,
                               int B, int S, int F, float vs, float* feats, float* pos,
                               void* stream) {
  long long n = (long long)B * S * F;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    if (bf16)
      mesh_lattice_kernel<__nv_bfloat16><<<blocks(n), kThreads, 0, st>>>(
          voxel_ids, corner_idx, static_cast<const __nv_bfloat16*>(emb), lat_coords, fr, w, n, S,
          F, vs, feats, pos);
    else
      mesh_lattice_kernel<float><<<blocks(n), kThreads, 0, st>>>(
          voxel_ids, corner_idx, static_cast<const float*>(emb), lat_coords, fr, w, n, S, F, vs,
          feats, pos);
  }
  return (int)cudaGetLastError();
}

// tris (B * ncell, 12, 3, 3) and valid (B * ncell, 12); voxel_ids may be null
extern "C" int nl_marching_tets(const float* sdf, const float* pos, const int* cct,
                                const int* voxel_ids, int B, int S, int ncell, float* tris,
                                unsigned char* valid, void* stream) {
  long long n = (long long)B * ncell * 6;
  if (n > 0)
    marching_tets_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        sdf, pos, cct, voxel_ids, n, S, ncell, tris, valid);
  return (int)cudaGetLastError();
}
