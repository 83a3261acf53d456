// K10a and K10b: the two device passes of mesh extraction (port of
// nerfloam_tpu/map/mesher.py:59-82 _mesh_chunk and nerfloam_tpu/ops/
// marching.py:63-106 marching_tets_cells). The decoder runs between them
// in torch (a plain matrix product, as in JAX).
//
// K10a mesh_lattice: a group of G = F / 4 lanes per surface voxel b, each
// lane owning four features. The group reads the voxel's id and its 8
// corner ids once (lanes split the loads and pass them by shuffle), and
// each lane its four features of the 8 corner rows, through clip(cidx, 0)
// as JAX reads them, in one 16-byte (f32) or 8-byte (bf16) load a row,
// widened to f32 and kept in registers. The block stages the (S, 8)
// trilinear weights and the (S, 3) fractions in shared memory once. A lane
// then walks the S samples, summing in corner order j = x<<2 | y<<1 | z,
// one rounded product and one rounded add per corner (no FMA), from the
// first product, and stores one float4 a sample, so at res 2 (weights 0 /
// 1) the features are the corner rows themselves. The group's lanes also
// write the voxel's (S, 3) positions base + fr * vs, consecutive floats.
// Templated on F (8, 16, 32) and res (2, 3, 4): every index is 32-bit
// arithmetic on compile-time divisors (the wrapper bounds B * S * F). Its
// first form, a thread per (voxel, sample, feature) with 64-bit divisions
// by the run-time F and S, re-reading the ids and weights and loading one
// entry at a time, took 4.3-4.6x as long (res 2 and 4, bf16 and f32).
//
// K10b marching_tets: a thread per (cell, Kuhn tetrahedron), 64 cells (a
// tile) per block. A tet gathers its 4 lattice samples through the
// cell-corner table, forms the sign case and the 6 edge zero crossings
// t = va / (va - vb) (clipped to [0, 1], the denominator replaced by 1e-12
// when smaller), and takes the case's up to 2 triangles from the tables
// (copied to shared memory: threads of different cases would serialise
// on the constant cache). Every operation is a single IEEE-rounded one in
// JAX's order, so a vertex shared by two cells or two voxels comes out
// bitwise equal from both and the host's weld merges it. One kernel, two
// forms (a template flag):
//   padded   JAX's output: all 12 triangle slots of a cell and their mask
//            (unused slots hold edge 0's vertex, as the JAX gather through
//            clip(., 0) leaves them), for the JAX signature and the tests.
//   compact  what the mesh path needs: only the valid triangles, in
//            ascending (cell, tet, slot) order, i.e. exactly tris[valid] of
//            the padded form, and their count T. Each block stages its
//            tile's valid triangles in shared memory (a block-wide scan of
//            the per-thread counts places them), takes its offset by a
//            decoupled look-back over the tiles before it (each block
//            takes the next tile from a ticket, publishes its count after
//            its scan, adds its predecessors' back to one that has
//            published its inclusive prefix, as csrc/reconcile.cu's scan
//            does) and writes them with coalesced 16-byte stores. The
//            last tile writes T; the last block to finish resets the tile
//            states and both tickets, so a kept scratch needs no fill per
//            call, and the output buffer is allocated, never filled.
//
// Bound on the H100: both are memory-bound by their bytes. K10a reads 8
// rows of F embeddings per voxel (once, into registers) and writes S * (F
// + 3) floats per voxel. K10b reads 4 floats per lattice
// sample (B * S * 16 bytes; L1 and L2 serve the 6 tets' re-reads); the
// padded form writes 12 x (36 + 1) bytes per cell, 444 B, by 4-byte
// stores 72 B apart, which take most of its time; the compact form writes
// 36 B per valid triangle (~1.7 a cell on the kernel phase's map at res
// 2) and 4 for T. The compact form takes more than its bytes in
// instructions: 64-bit index arithmetic cost a third of its time (hence
// 32-bit cell indices, which the wrapper bounds), and the edges' ends are
// arithmetic the compiler folds, not a table read at run time (which left
// the tet's values in local memory). Computing the edges only for the cut
// tets, in a second pass over a list of them, took longer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLatThreads = 256;                // K10a: threads per block
constexpr int kTetCells = 64;                   // K10b: cells per block (a tile)
constexpr int kTetThreads = 6 * kTetCells;      // a thread per (cell, tetrahedron)
constexpr int kTetWarps = kTetThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // a tile's own count is published
constexpr unsigned long long kPrefix = 2ull << 32;     // its inclusive prefix is

// four embedding entries from 16 (f32) or 8 (bf16) aligned bytes, as f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));  // entry 2i in x's low half
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

struct LatticeArgs {
  const int* voxel_ids;   // (B,), -1 pads
  const int* corner_idx;  // (C, 8)
  const void* emb;        // (C, F) f32 or bf16
  const int* lat_coords;  // (C, 3)
  const float* fr;        // (S, 3) lattice fractions
  const float* w;         // (S, 8) trilinear weights
  int B;
  float vs;
  float* feats;  // (B, S, F)
  float* pos;    // (B, S, 3)
};

template <typename Emb, int F, int RES>
__global__ void __launch_bounds__(kLatThreads) mesh_lattice_kernel(const LatticeArgs a) {
  constexpr int S = RES * RES * RES;
  constexpr int G = F / 4;                 // lanes per voxel
  constexpr int kVoxels = kLatThreads / G;  // voxels per block
  static_assert(F % 4 == 0 && 32 % G == 0, "a voxel's group must tile a warp");
  __shared__ float s_w[S * 8], s_fr[S * 3];
  for (int i = threadIdx.x; i < S * 8; i += kLatThreads) s_w[i] = a.w[i];
  for (int i = threadIdx.x; i < S * 3; i += kLatThreads) s_fr[i] = a.fr[i];
  __syncthreads();
  const int q = threadIdx.x % G;
  const int b = blockIdx.x * kVoxels + threadIdx.x / G;
  if (b >= a.B) return;  // the whole group: its lanes share b
  const int lane = threadIdx.x % 32;
  const unsigned group = G == 32 ? kFull : ((1u << G) - 1u) << (lane - q);
  // the voxel's row, then its corners' and its coords, the loads split
  // over the group's lanes and passed by shuffle
  int v = q == 0 ? a.voxel_ids[b] : 0;
  v = __shfl_sync(group, v < 0 ? 0 : v, 0, G);
  constexpr int kPer = (8 + G - 1) / G;
  int mine[kPer], cmine[(3 + G - 1) / G];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = q + k * G;
    const int c = j < 8 ? a.corner_idx[8 * v + j] : 0;
    mine[k] = c < 0 ? 0 : c;
  }
#pragma unroll
  for (int k = 0; k < (3 + G - 1) / G; ++k) {
    const int c = q + k * G;
    cmine[k] = c < 3 ? a.lat_coords[3 * v + c] : 0;
  }
  const Emb* emb = static_cast<const Emb*>(a.emb);
  float e[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = __shfl_sync(group, mine[j / G], j % G, G);
    load4(emb + (size_t)row * F + 4 * q, e[j]);
  }
  float base[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    base[c] = __fmul_rn((float)__shfl_sync(group, cmine[c / G], c % G, G), a.vs);
  float* out = a.feats + b * (S * F) + 4 * q;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    float acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fmul_rn(s_w[8 * s], e[0][k]);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const float wj = s_w[8 * s + j];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, e[j][k]));
    }
    *reinterpret_cast<float4*>(out + s * F) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  float* po = a.pos + b * (S * 3);
  for (int i = q; i < 3 * S; i += G) {
    const int c = i % 3;
    const float bc = c == 0 ? base[0] : (c == 1 ? base[1] : base[2]);
    po[i] = __fadd_rn(bc, __fmul_rn(s_fr[i], a.vs));
  }
}

// ops/marching.py: TET_CORNERS, EDGE_PAIRS, TRI_TABLE
__constant__ int c_tet_corners[6][4] = {
    {0, 4, 6, 7}, {0, 4, 5, 7}, {0, 2, 6, 7}, {0, 2, 3, 7}, {0, 1, 5, 7}, {0, 1, 3, 7}};
constexpr int c_edge_pairs[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
__constant__ int c_tri_table[16][2][3] = {
    {{-1, -1, -1}, {-1, -1, -1}}, {{0, 1, 2}, {-1, -1, -1}}, {{0, 3, 4}, {-1, -1, -1}},
    {{1, 2, 4}, {1, 4, 3}},       {{1, 5, 3}, {-1, -1, -1}}, {{0, 2, 5}, {0, 5, 3}},
    {{0, 4, 5}, {0, 5, 1}},       {{2, 4, 5}, {-1, -1, -1}}, {{2, 5, 4}, {-1, -1, -1}},
    {{0, 1, 5}, {0, 5, 4}},       {{0, 3, 5}, {0, 5, 2}},    {{1, 3, 5}, {-1, -1, -1}},
    {{1, 4, 2}, {1, 3, 4}},       {{0, 4, 3}, {-1, -1, -1}}, {{0, 2, 1}, {-1, -1, -1}},
    {{-1, -1, -1}, {-1, -1, -1}}};

// the ends of tet edge e, c_edge_pairs[e], as arithmetic the compiler folds
// in an unrolled loop (a table read at run time would leave the tet's
// values to be picked by selects or from local memory)
__host__ __device__ constexpr int edge_a(int e) { return e < 3 ? 0 : (e < 5 ? 1 : 2); }
__host__ __device__ constexpr int edge_c(int e) { return e < 3 ? e + 1 : (e < 5 ? e - 1 : 3); }
constexpr bool edge_ends_match(int e = 0) {
  return e == 6 || (edge_a(e) == c_edge_pairs[e][0] && edge_c(e) == c_edge_pairs[e][1] &&
                    edge_ends_match(e + 1));
}
static_assert(edge_ends_match(), "edge_a / edge_c differ from c_edge_pairs");

// the sign case of the tet with lattice corners ``corners`` (its row of
// TET_CORNERS) of cell ci of voxel b, and its 6 edge vertices
// the sign case of the tet with lattice corners ``corners`` (its row of
// TET_CORNERS) of cell ci of voxel b (bit k set where corner k is inside),
// and its 6 edge vertices
__device__ __forceinline__ int tet_edges(const float* __restrict__ sdf,
                                         const float* __restrict__ pos,
                                         const int* __restrict__ cct, const int* corners, int b,
                                         int ci, int S, float ev[6][3]) {
  const int* cc = cct + 8 * ci;
  float v[4], p[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    long long lat = (long long)b * S + cc[corners[k]];
    v[k] = sdf[lat];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[k][d] = pos[lat * 3 + d];
  }
  int cs = (v[0] < 0.0f) | ((v[1] < 0.0f) << 1) | ((v[2] < 0.0f) << 2) | ((v[3] < 0.0f) << 3);
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int a = edge_a(e), c = edge_c(e);
    float den = __fsub_rn(v[a], v[c]);
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    float tt = __fdiv_rn(v[a], den);
    tt = tt < 0.0f ? 0.0f : (tt > 1.0f ? 1.0f : tt);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      ev[e][d] = __fadd_rn(p[a][d], __fmul_rn(tt, __fsub_rn(p[c][d], p[a][d])));
  }
  return cs;
}

// out = ev[e] for a runtime e, by selects over the unrolled 6 (an index
// into ev would put it in local memory)
__device__ __forceinline__ void edge_vertex(const float ev[6][3], int e, float out[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float x = ev[0][d];
#pragma unroll
    for (int k = 1; k < 6; ++k) x = e == k ? ev[k][d] : x;
    out[d] = x;
  }
}

// kCompact false: tris (ncells, 12, 3, 3) and valid (ncells, 12), tile =
// blockIdx.x. kCompact true: tris (T, 3, 3), count = T, the look-back's
// ticket pair ctr (next tile, blocks done) and tile states tile_state, all
// zero between calls.
template <bool kCompact>
__global__ void __launch_bounds__(kTetThreads)
    marching_tets_kernel(const float* __restrict__ sdf, const float* __restrict__ pos,
                         const int* __restrict__ cct, const int* __restrict__ voxel_ids,
                         int ncells, int S, int ncell, float* __restrict__ tris,
                         unsigned char* __restrict__ valid, int* __restrict__ count,
                         unsigned* ctr, unsigned long long* tile_state) {
  __shared__ float s_tris[kCompact ? kTetThreads * 2 * 9 : 1];  // the tile's valid triangles
  __shared__ int s_warp[kTetWarps];
  __shared__ int s_tile, s_offset;
  __shared__ bool s_last;
  // the tables, read by threads of different cases and tets: from shared
  // memory rather than the constant cache, which serialises such reads
  __shared__ int s_corners[6][4];
  __shared__ signed char s_table[16][2][3];
  if (threadIdx.x < 24) (&s_corners[0][0])[threadIdx.x] = (&c_tet_corners[0][0])[threadIdx.x];
  if (threadIdx.x < 96)
    (&s_table[0][0][0])[threadIdx.x] = (signed char)(&c_tri_table[0][0][0])[threadIdx.x];
  if (kCompact && threadIdx.x == 0) s_tile = (int)atomicAdd(ctr, 1u);
  __syncthreads();
  const int tile = kCompact ? s_tile : (int)blockIdx.x;
  const int cell = tile * kTetCells + (int)threadIdx.x / 6;  // < 2^31 / 12: the wrapper checks
  const int tet = threadIdx.x % 6;
  const bool live = cell < ncells;
  const int b = live ? cell / ncell : 0;
  const bool vox_ok = live && (voxel_ids == nullptr || voxel_ids[b] >= 0);
  if (!kCompact) {
    if (!live) return;
    float ev[6][3];
    const int cs = tet_edges(sdf, pos, cct, s_corners[tet], b, cell - b * ncell, S, ev);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long slot = cell * 12LL + tet * 2 + s;
      valid[slot] = (s_table[cs][s][0] >= 0) && vox_ok;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float x[3];
        edge_vertex(ev, s_table[cs][s][k], x);  // -1 (unused) reads edge 0
#pragma unroll
        for (int d = 0; d < 3; ++d) tris[(slot * 3 + k) * 3 + d] = x[d];
      }
    }
    return;
  }
  // this thread's valid triangles (slot 1 is valid only where slot 0 is)
  float ev[6][3];
  int cs = 0, n = 0;
  if (vox_ok) {
    cs = tet_edges(sdf, pos, cct, s_corners[tet], b, cell - b * ncell, S, ev);
    n = (s_table[cs][0][0] >= 0) + (s_table[cs][1][0] >= 0);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kTetWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    agg += s_warp[w];
  }
  if (warp == 0 && lane == 0 && tile > 0)  // this tile's count, for the tiles after it
    atomicExch(tile_state + tile, kAggregate | (unsigned)agg);
  // stage the triangles in thread order, i.e. (cell, tet, slot) order
  float* st = s_tris + 9 * (before + incl - n);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < n) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float x[3];
        edge_vertex(ev, s_table[cs][s][k], x);
#pragma unroll
        for (int d = 0; d < 3; ++d) st[9 * s + 3 * k + d] = x[d];
      }
    }
  }
  if (warp == 0) {  // look back over 32 predecessors at a time, a lane each
    int excl = 0;
    if (tile > 0) {
      volatile unsigned long long* sv = tile_state;
      for (int top = tile - 1; top >= 0; top -= 32) {
        const int p = top - lane;
        unsigned long long v = kPrefix;  // before tile 0: a prefix of 0
        if (p >= 0) v = sv[p];
        while (__any_sync(kFull, (v >> 32) == 0))  // not all published yet
          if ((v >> 32) == 0) v = sv[p];
        // add back to the nearest predecessor that has its inclusive prefix
        const unsigned has = __ballot_sync(kFull, (v & ~0xffffffffull) == kPrefix);
        const int stop = has ? __ffs(has) - 1 : 31;
        int part = lane <= stop ? (int)(unsigned)v : 0;
        for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
        excl += part;
        if (has) break;
      }
    }
    if (lane == 0) {
      atomicExch(tile_state + tile, kPrefix | (unsigned)(excl + agg));
      s_offset = excl;
      if (tile == gridDim.x - 1) *count = excl + agg;  // the last tile: T
    }
  }
  __syncthreads();  // the tile is staged and placed; this block reads no tile state again
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ctr + 1, 1u) == gridDim.x - 1;
  }
  // the tile's 9 * agg floats to tris + 9 * offset: a head up to the first
  // 16-byte boundary, float4 stores, a tail
  const long long g0 = 9LL * s_offset;
  const int nf = 9 * agg;
  float* dst = tris + g0;
  int head = (int)((4 - (g0 & 3)) & 3);
  if (head > nf) head = nf;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = s_tris[threadIdx.x];
  const int nv = (nf - head) >> 2;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += kTetThreads) {
    const float* q = s_tris + head + 4 * i;
    dst4[i] = make_float4(q[0], q[1], q[2], q[3]);
  }
  const int tail = head + 4 * nv;
  if ((int)threadIdx.x < nf - tail) dst[tail + threadIdx.x] = s_tris[tail + threadIdx.x];
  __syncthreads();
  if (s_last) {  // every block has finished its look-back: reset for the next call
    for (int i = threadIdx.x; i < gridDim.x; i += kTetThreads) tile_state[i] = 0ull;
    if (threadIdx.x == 0) ctr[0] = ctr[1] = 0u;
  }
}

template <typename Emb, int F, int RES>
void launch_lattice(const LatticeArgs& a, cudaStream_t st) {
  constexpr int kVoxels = kLatThreads / (F / 4);
  mesh_lattice_kernel<Emb, F, RES><<<(a.B + kVoxels - 1) / kVoxels, kLatThreads, 0, st>>>(a);
}

template <typename Emb, int F>
bool launch_lattice(int res, const LatticeArgs& a, cudaStream_t st) {
  switch (res) {
    case 2: return launch_lattice<Emb, F, 2>(a, st), true;
    case 3: return launch_lattice<Emb, F, 3>(a, st), true;
    case 4: return launch_lattice<Emb, F, 4>(a, st), true;
  }
  return false;
}

template <typename Emb>
bool launch_lattice(int F, int res, const LatticeArgs& a, cudaStream_t st) {
  switch (F) {
    case 8: return launch_lattice<Emb, 8>(res, a, st);
    case 16: return launch_lattice<Emb, 16>(res, a, st);
    case 32: return launch_lattice<Emb, 32>(res, a, st);
  }
  return false;
}

}  // namespace

// feats (B, res^3, F) and pos (B, res^3, 3) for B voxel ids (-1 pads read
// row 0); F in {8, 16, 32}, res in {2, 3, 4}, B * res^3 * F < 2^31, emb
// 16-byte aligned
extern "C" int nl_mesh_lattice(const int* voxel_ids, const int* corner_idx, const void* emb,
                               int bf16, const int* lat_coords, const float* fr, const float* w,
                               int B, int res, int F, float vs, float* feats, float* pos,
                               void* stream) {
  if ((long long)B * res * res * res * F >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const LatticeArgs a{voxel_ids, corner_idx, emb, lat_coords, fr, w, B, vs, feats, pos};
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0 && !(bf16 ? launch_lattice<__nv_bfloat16>(F, res, a, st)
                      : launch_lattice<float>(F, res, a, st)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

inline int tet_tiles(long long ncells) { return (int)((ncells + kTetCells - 1) / kTetCells); }

// the compact form's tiles for B * ncell cells: its scratch holds one
// 8-byte word for the ticket pair and one tile state per tile
extern "C" int nl_marching_tets_tiles(int ncells) { return tet_tiles(ncells); }

// padded: tris (B * ncell, 12, 3, 3) and valid (B * ncell, 12); voxel_ids
// may be null
extern "C" int nl_marching_tets(const float* sdf, const float* pos, const int* cct,
                                const int* voxel_ids, int B, int S, int ncell, float* tris,
                                unsigned char* valid, void* stream) {
  const long long n = (long long)B * ncell;
  if (12 * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // 32-bit slot indices
  if (n > 0)
    marching_tets_kernel<false><<<tet_tiles(n), kTetThreads, 0, (cudaStream_t)stream>>>(
        sdf, pos, cct, voxel_ids, (int)n, S, ncell, tris, valid, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// compact: the valid triangles into tris (at least B * ncell * 12 rows of
// 9 floats, 16-byte aligned), their count into *count; scratch (zero
// between calls, left so) holds 1 + nl_marching_tets_tiles(B * ncell)
// words
extern "C" int nl_marching_tets_compact(const float* sdf, const float* pos, const int* cct,
                                        const int* voxel_ids, int B, int S, int ncell,
                                        float* tris, int* count, unsigned long long* scratch,
                                        void* stream) {
  const long long n = (long long)B * ncell;
  if (12 * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // 32-bit slot indices
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0)
    marching_tets_kernel<true><<<tet_tiles(n), kTetThreads, 0, st>>>(
        sdf, pos, cct, voxel_ids, (int)n, S, ncell, tris, nullptr, count,
        reinterpret_cast<unsigned*>(scratch), scratch + 1);
  else
    cudaMemsetAsync(count, 0, sizeof(int), st);
  return (int)cudaGetLastError();
}
