// K7: voxel insert (port of nerfloam_tpu/map/voxel_map.py:311-449
// insert_points, as driven by insert_frame 535-575 with support points),
// in place, with a record of what it overwrote.
//
// Four launches (five with the active-set append), all on tables the
// caller hands in and on a scratch it keeps between calls: two election
// grids (one per election, each the region's size) held at INT_MAX, the
// compacted candidates and their corner cells, and the tile states of
// three one-pass scans. Each thread issues its loads a phase at a time
// (all of its points' or corners' loads of one kind in flight together),
// old values before any store.
//   elect      every point's cell, floor(p / vs); in-region valid points
//              elect their cell's representative by atomicMin of the point
//              slot into the first grid (the smallest slot wins). Block 0
//              zeroes the three scans' tile states and tickets and copies
//              the old num_lat, n_active and num_cand into the record.
//   candidate  by tiles of points: a point that won its cell resets the
//              cell to INT_MAX (a loser reads the winner's slot or INT_MAX,
//              never its own) and is a new-voxel candidate when the cell is
//              not already a surface voxel. A decoupled look-back scan
//              ranks the candidates in ascending point slot; a candidate
//              of rank k < cand_cap takes row k of the compacted voxels,
//              and each of its 8 corners that is in region and not
//              allocated elects its cell by atomicMin of the corner slot
//              8k + j into the second grid. The last tile writes num_cand
//              (the true count, it may exceed cand_cap).
//   alloc      by tiles of kept candidates (a loop over the count, not the
//              cap): a corner slot that won its cell resets it; the new
//              corners are ranked in ascending slot, and the corner of
//              rank r takes row num_lat + r if it fits the capacity: its
//              old coords and grid cell go to the record, then its coords
//              and grid entry are written. The last tile writes num_lat
//              (it counts the rows past the capacity, as the twin does).
//   activate   by tiles of kept candidates: each looks its 8 corners up in
//              the updated grid; a complete set makes the voxel (its
//              corner-0 row) surface and sets its corner_idx, the old
//              values recorded first. With the active-set append, the
//              activated voxels are ranked and the one of rank r takes
//              slot n_active + r if it fits: its old id, coords and grid
//              cell go to the record, then the new ones are written. The
//              last tile writes the counts and n_active.
//   pack       (with the append) the appended slots' packed rows, spread
//              over the whole card (written by each tile's own block they
//              took 30 us on the H100 at the quality shape): a thread a
//              float4 of one corner's features,
//              grid-stride over the appended count; the old row goes to
//              the record first.
// undo         (csrc/insert.cu nl_insert_undo, one launch) writes the
//              record back: the rows past the old num_lat and their grid
//              cells, the activated voxels' surface flags and corner rows,
//              the appended slots with their grid_active cells and packed
//              rows, and the three scalars. It reads only the record, so a
//              second undo of one record changes nothing.
// Ranks are in ascending point, slot and candidate order, so every table
// is the one the plain twin's torch.cumsum gives. JAX leaves the election
// winner unspecified; electing the smallest slot makes this kernel and
// its plain torch twin agree exactly on every table and record.
//
// Bound on the H100: at the quality config 196,608 points, ~5,000
// candidates, ~6,500 new rows and ~5,000 appended voxels: the points, one
// grid and surface read each, 8 corner cells per candidate, the new rows,
// the activated voxels and the appended rows (512 B each) with their old
// values and record. The whole-grid fills (19.9 MB each) are paid once
// per scratch, not per call, and nothing is copied: the tables are
// written in place.
//
// Rounding: floor(p / vs) uses __fdiv_rn (and -fmad=false), the IEEE
// division the plain version takes, so both see the same cells.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointItems = 4;                         // points a thread in the candidate pass
constexpr int kPointTile = kThreads * kPointItems;     // points a tile
constexpr int kCandTile = kThreads;                    // candidates a tile (one a thread)
constexpr int kMaxBlocks = 264;                        // two a SM: tiles are taken by ticket
constexpr int kRowInts = 5;                            // record: old coords, cell, old grid
constexpr int kActInts = 10;                           // vid, old surface, old corner rows
constexpr int kAppInts = 6;                            // old id, old coords, cell, old entry
constexpr int kHeader = 8;  // num_lat0, n_active0, num_cand0, rows, activated, appended
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // a tile's own count is published
constexpr unsigned long long kPrefix = 2ull << 32;     // its inclusive prefix is

__device__ __forceinline__ int flat_cell(int x, int y, int z, const int* rmin, int Dx, int Dy,
                                         int Dz) {
  x -= rmin[0];
  y -= rmin[1];
  z -= rmin[2];
  if (x < 0 || x >= Dx || y < 0 || y >= Dy || z < 0 || z >= Dz) return -1;
  return (x * Dy + y) * Dz + z;
}

// the next tile of a pass, taken by ticket (tiles are ranked in ticket order)
__device__ __forceinline__ int next_tile(int* ticket) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  return s_tile;
}

// The rank of this thread's first flagged item among all flagged items of
// the earlier tiles and the earlier threads of this tile (``mine`` its own
// count), by a block scan and a decoupled look-back over the tiles' states;
// *end is the count up to the end of this tile.
__device__ int scan_rank(int mine, int tile, unsigned long long* tile_state, int* end) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_prefix, s_end;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    agg += s_warp[w];
  }
  if (warp == 0) {  // look back over 32 predecessors at a time, a lane each
    int excl = 0;
    if (tile > 0) {
      if (lane == 0) atomicExch(tile_state + tile, kAggregate | (unsigned)agg);
      volatile unsigned long long* st = tile_state;
      for (int top = tile - 1; top >= 0; top -= 32) {
        const int p = top - lane;
        unsigned long long v = kPrefix;  // before tile 0: a prefix of 0
        if (p >= 0) v = st[p];
        while (__any_sync(kFull, (v >> 32) == 0))  // not all published yet
          if ((v >> 32) == 0) v = st[p];
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
      s_prefix = excl;
      s_end = excl + agg;
    }
  }
  __syncthreads();
  const int r = s_prefix + before + incl - mine;
  *end = s_end;
  __syncthreads();  // the shared words are the next tile's
  return r;
}

__device__ __forceinline__ void point_cell(const float* pts, int i, float vs, int* c) {
#pragma unroll
  for (int a = 0; a < 3; ++a) c[a] = (int)floorf(__fdiv_rn(pts[3 * i + a], vs));
}

__global__ void __launch_bounds__(kThreads) insert_elect_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid, int P, float vs,
    const int* __restrict__ rmin, int Dx, int Dy, int Dz, int* __restrict__ winner,
    const int* __restrict__ num_lat, const int* __restrict__ n_active,
    const int* __restrict__ num_cand, int* __restrict__ header,
    unsigned long long* __restrict__ scan, int n_scan) {
  if (blockIdx.x == 0) {  // the scans' states and tickets, and the old scalars
    for (int t = threadIdx.x; t < n_scan; t += kThreads) scan[t] = 0;
    if (threadIdx.x == 0) {
      header[0] = *num_lat;
      header[1] = *n_active;
      header[2] = *num_cand;
    }
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P || !valid[i]) return;
  int c[3];
  point_cell(pts, i, vs, c);
  const int f = flat_cell(c[0], c[1], c[2], rmin, Dx, Dy, Dz);
  if (f >= 0) atomicMin(winner + f, i);
}

__global__ void __launch_bounds__(kThreads) insert_candidate_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid, int P, float vs,
    const int* __restrict__ rmin, int Dx, int Dy, int Dz, int Pc, int* winner, int* cwinner,
    const int* __restrict__ grid, const unsigned char* __restrict__ is_surface,
    int* __restrict__ vox_c, int* __restrict__ cflat, int* __restrict__ num_cand,
    unsigned long long* tile_state, int* ticket) {
  if (P == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *num_cand = 0;
    return;
  }
  const int n_tiles = (P + kPointTile - 1) / kPointTile;
  for (int tile = next_tile(ticket); tile < n_tiles; tile = next_tile(ticket)) {
    // each load phase covers the thread's points at once (kPointItems loads
    // in flight): cells, their election winners, the winners' grid rows,
    // those rows' surface flags
    const int i0 = tile * kPointTile + threadIdx.x * kPointItems;
    int vox[kPointItems][3], f[kPointItems], lid[kPointItems];
#pragma unroll
    for (int k = 0; k < kPointItems; ++k) {
      const int i = i0 + k;
      f[k] = -1;
      if (i >= P || !valid[i]) continue;
      point_cell(pts, i, vs, vox[k]);
      f[k] = flat_cell(vox[k][0], vox[k][1], vox[k][2], rmin, Dx, Dy, Dz);
    }
    bool won[kPointItems];
#pragma unroll
    for (int k = 0; k < kPointItems; ++k) won[k] = f[k] >= 0 && winner[f[k]] == i0 + k;
#pragma unroll
    for (int k = 0; k < kPointItems; ++k) {
      if (won[k]) winner[f[k]] = INT_MAX;  // for the next call
      lid[k] = won[k] ? grid[f[k]] : -1;
    }
    unsigned flags = 0;
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kPointItems; ++k) {
      if (!won[k] || (lid[k] >= 0 && is_surface[lid[k]])) continue;
      flags |= 1u << k;
      ++mine;
    }
    int end;
    int r = scan_rank(mine, tile, tile_state, &end);
    if (tile == n_tiles - 1 && threadIdx.x == 0) *num_cand = end;
#pragma unroll
    for (int k = 0; k < kPointItems; ++k) {
      if (!(flags >> k & 1u)) continue;
      if (r < Pc) {
        const int v0 = vox[k][0], v1 = vox[k][1], v2 = vox[k][2];
        vox_c[3 * r] = v0;
        vox_c[3 * r + 1] = v1;
        vox_c[3 * r + 2] = v2;
        int cf[8];  // the corners' cells where they are in region and unallocated
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cf[j] = flat_cell(v0 + ((j >> 2) & 1), v1 + ((j >> 1) & 1), v2 + (j & 1), rmin, Dx,
                            Dy, Dz);
          if (cf[j] >= 0 && grid[cf[j]] >= 0) cf[j] = -1;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cflat[8 * r + j] = cf[j];
          if (cf[j] >= 0) atomicMin(cwinner + cf[j], 8 * r + j);
        }
      }
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kThreads) insert_alloc_kernel(
    const int* __restrict__ num_cand, int Pc, int* cwinner, const int* __restrict__ cflat,
    const int* __restrict__ vox_c, int C, int* __restrict__ lat_coords, int* __restrict__ grid,
    int* __restrict__ num_lat, int* __restrict__ header, int* __restrict__ rec_rows,
    unsigned long long* tile_state, int* ticket) {
  const int nk = min(*num_cand, Pc), num_lat0 = header[0];
  if (nk == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *num_lat = num_lat0;
      header[3] = 0;
    }
    return;
  }
  const int n_tiles = (nk + kCandTile - 1) / kCandTile;
  for (int tile = next_tile(ticket); tile < n_tiles; tile = next_tile(ticket)) {
    const int k = tile * kCandTile + threadIdx.x;
    int f[8];
    unsigned fresh = 0;
    if (k < nk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 8 * k + j;
        f[j] = cflat[s];
        if (f[j] >= 0 && cwinner[f[j]] == s) {
          cwinner[f[j]] = INT_MAX;  // for the next call
          fresh |= 1u << j;
        }
      }
    }
    int end;
    const int r = scan_rank(__popc(fresh), tile, tile_state, &end);
    if (tile == n_tiles - 1 && threadIdx.x == 0) {
      *num_lat = num_lat0 + end;
      header[3] = max(0, min(num_lat0 + end, C) - num_lat0);
    }
    if (!fresh) continue;
    const int v0 = vox_c[3 * k], v1 = vox_c[3 * k + 1], v2 = vox_c[3 * k + 2];
    // the rows' old coords and grid entries, all loaded before any store
    int id[8], old[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      id[j] = num_lat0 + r + __popc(fresh & ((1u << j) - 1));
      if (!(fresh >> j & 1u) || id[j] >= C) continue;
      const int* lat = lat_coords + 3 * (size_t)id[j];
      old[j][0] = lat[0];
      old[j][1] = lat[1];
      old[j][2] = lat[2];
      old[j][3] = grid[f[j]];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(fresh >> j & 1u) || id[j] >= C) continue;
      int* rec = rec_rows + kRowInts * (id[j] - num_lat0);
      int* lat = lat_coords + 3 * (size_t)id[j];
      rec[0] = old[j][0];
      rec[1] = old[j][1];
      rec[2] = old[j][2];
      rec[3] = f[j];
      rec[4] = old[j][3];
      lat[0] = v0 + ((j >> 2) & 1);
      lat[1] = v1 + ((j >> 1) & 1);
      lat[2] = v2 + (j & 1);
      grid[f[j]] = id[j];
    }
  }
}

// 4 embedding features from 16 (f32) or 8 (bf16) bytes, as f32
__device__ __forceinline__ float4 emb4(const void* emb, int bf16, size_t at) {
  if (bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(emb) + at);
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(emb) + at);
}

__global__ void __launch_bounds__(kThreads) insert_activate_kernel(
    const int* __restrict__ num_cand, int Pc, const int* __restrict__ vox_c,
    const int* __restrict__ rmin, int Dx, int Dy, int Dz, const int* __restrict__ grid,
    unsigned char* __restrict__ is_surface, int* __restrict__ corner_idx, int append, int A,
    int* __restrict__ active_ids, int* __restrict__ active_coords, int* __restrict__ grid_active,
    int* __restrict__ n_active, int* __restrict__ header, int* __restrict__ rec_act,
    int* __restrict__ rec_app, unsigned long long* tile_state, int* ticket) {
  const int nk = min(*num_cand, Pc), n_active0 = header[1];
  if (nk == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) header[4] = header[5] = 0;
    return;
  }
  const int n_tiles = (nk + kCandTile - 1) / kCandTile;
  for (int tile = next_tile(ticket); tile < n_tiles; tile = next_tile(ticket)) {
    const int k = tile * kCandTile + threadIdx.x;
    int v[3] = {0, 0, 0}, ids[8];
    bool act = false;
    if (k < nk) {
      v[0] = vox_c[3 * k], v[1] = vox_c[3 * k + 1], v[2] = vox_c[3 * k + 2];
      act = true;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = flat_cell(v[0] + ((j >> 2) & 1), v[1] + ((j >> 1) & 1), v[2] + (j & 1),
                                rmin, Dx, Dy, Dz);
        ids[j] = f >= 0 ? grid[f] : -1;
        act = act && ids[j] >= 0;
      }
    }
    int end;
    const int r = scan_rank(act, tile, tile_state, &end);
    if (tile == n_tiles - 1 && threadIdx.x == 0) {
      header[4] = end;
      header[5] = append ? max(0, min(n_active0 + end, A) - n_active0) : 0;
      if (append) *n_active = n_active0 + end;
    }
    if (!act) continue;
    const int vid = ids[0], pos = n_active0 + r;
    const bool app = append && pos < A;
    const int cell = app ? flat_cell(v[0], v[1], v[2], rmin, Dx, Dy, Dz) : 0;
    // the old values, all loaded before any store
    int* cidx = corner_idx + 8 * (size_t)vid;
    int old[10], old_app[6];
    old[0] = vid;
    old[1] = is_surface[vid];
#pragma unroll
    for (int j = 0; j < 8; ++j) old[2 + j] = cidx[j];
    if (app) {
      old_app[0] = active_ids[pos];
      old_app[1] = active_coords[3 * pos];
      old_app[2] = active_coords[3 * pos + 1];
      old_app[3] = active_coords[3 * pos + 2];
      old_app[4] = cell;
      old_app[5] = grid_active[cell];
    }
#pragma unroll
    for (int j = 0; j < kActInts; ++j) rec_act[kActInts * r + j] = old[j];
    is_surface[vid] = 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) cidx[j] = ids[j];
    if (!app) continue;
#pragma unroll
    for (int j = 0; j < kAppInts; ++j) rec_app[kAppInts * r + j] = old_app[j];
    active_ids[pos] = vid;
    active_coords[3 * pos] = v[0];
    active_coords[3 * pos + 1] = v[1];
    active_coords[3 * pos + 2] = v[2];
    grid_active[cell] = pos;
  }
}

// the appended slots' packed rows, spread over the whole card: a float4 of
// one corner's features a thread (grid-stride over the appended count),
// the old one to the record first
__global__ void __launch_bounds__(kThreads) insert_pack_kernel(
    const int* __restrict__ header, int F, const void* __restrict__ emb, int bf16,
    const int* __restrict__ active_ids, const int* __restrict__ corner_idx,
    float* __restrict__ packed, float* __restrict__ rec_packed) {
  const int n_active0 = header[1], n_app = header[5];
  const int quads = 2 * F;  // float4s of a packed row
  const long long n = (long long)n_app * quads;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int t = (int)(e / quads), q = (int)(e - (long long)t * quads);
    const int pos = n_active0 + t, j = 4 * q / F, f0 = 4 * q - j * F;
    const int id = corner_idx[8 * (size_t)active_ids[pos] + j];
    float4* dst = reinterpret_cast<float4*>(packed + (size_t)pos * 8 * F) + q;
    const float4 old = *dst;
    const float4 val = emb4(emb, bf16, (size_t)id * F + f0);
    reinterpret_cast<float4*>(rec_packed + (size_t)t * 8 * F)[q] = old;
    *dst = val;
  }
}

__global__ void __launch_bounds__(kThreads) insert_undo_kernel(
    const int* __restrict__ header, const int* __restrict__ rec_rows,
    const int* __restrict__ rec_act, const int* __restrict__ rec_app,
    const float* __restrict__ rec_packed, int F, int* __restrict__ lat_coords,
    int* __restrict__ grid, unsigned char* __restrict__ is_surface, int* __restrict__ corner_idx,
    int* __restrict__ active_ids, int* __restrict__ active_coords, int* __restrict__ grid_active,
    float* __restrict__ packed, int* __restrict__ num_lat, int* __restrict__ n_active,
    int* __restrict__ num_cand) {
  const int num_lat0 = header[0], n_active0 = header[1];
  const int n_rows = header[3], n_act = header[4], n_app = header[5];
  const int g = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;
  for (int t = g; t < n_rows; t += stride) {
    const int* rec = rec_rows + kRowInts * t;
    int* lat = lat_coords + 3 * (size_t)(num_lat0 + t);
    lat[0] = rec[0];
    lat[1] = rec[1];
    lat[2] = rec[2];
    grid[rec[3]] = rec[4];
  }
  for (int t = g; t < n_act; t += stride) {
    const int* rec = rec_act + kActInts * t;
    const int vid = rec[0];
    is_surface[vid] = (unsigned char)rec[1];
    for (int j = 0; j < 8; ++j) corner_idx[8 * (size_t)vid + j] = rec[2 + j];
  }
  for (int t = g; t < n_app; t += stride) {
    const int* app = rec_app + kAppInts * t;
    const int pos = n_active0 + t;
    active_ids[pos] = app[0];
    active_coords[3 * pos] = app[1];
    active_coords[3 * pos + 1] = app[2];
    active_coords[3 * pos + 2] = app[3];
    grid_active[app[4]] = app[5];
  }
  const int quads = 2 * F;
  for (long long e = g; e < (long long)n_app * quads; e += stride) {
    const int t = (int)(e / quads), q = (int)(e - (long long)t * quads);
    reinterpret_cast<float4*>(packed + (size_t)(n_active0 + t) * 8 * F)[q] =
        reinterpret_cast<const float4*>(rec_packed + (size_t)t * 8 * F)[q];
  }
  if (g == 0) {
    *num_lat = num_lat0;
    *n_active = n_active0;
    *num_cand = header[2];
  }
}

inline int blocks(long long n, int most) {
  return (int)std::max(1LL, std::min((long long)most, (n + kThreads - 1) / kThreads));
}

}  // namespace

// The scan scratch (int64 words) for P points and a candidate cap of Pc:
// two words of tickets, then the tile states of the three scans.
extern "C" int nl_insert_scan_words(int P, int Pc) {
  const int t_points = (P + kPointTile - 1) / kPointTile;
  const int t_cands = (Pc + kCandTile - 1) / kCandTile;
  return 2 + t_points + 2 * t_cands;
}

// In place: lat_coords, grid, is_surface, corner_idx, num_lat and num_cand,
// and with append != 0 active_ids, active_coords, grid_active, packed and
// n_active. winner and cwinner ((Dx*Dy*Dz,) each) hold INT_MAX on entry and
// are left so; vox_c (3 Pc), cflat (8 Pc) and scan (nl_insert_scan_words)
// are scratch. rec_ints: the header, R x 5 rows, Pc x 10 activated voxels,
// Aa x 6 appended slots; rec_packed: Aa x 8F floats. Embedding and packed
// rows 16-byte aligned, F % 4 == 0.
extern "C" int nl_insert(const float* pts, const unsigned char* valid, int P, float vs,
                         const int* rmin, int Dx, int Dy, int Dz, int Pc, int C, int A, int F,
                         int append, const void* emb, int bf16, int* lat_coords,
                         unsigned char* is_surface, int* corner_idx, int* grid, int* active_ids,
                         int* active_coords, int* grid_active, float* packed, int* num_lat,
                         int* n_active, int* num_cand, int* winner, int* cwinner, int* vox_c,
                         int* cflat, void* scan, int* rec_ints, float* rec_packed, int R,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* words = static_cast<unsigned long long*>(scan);
  int* tickets = reinterpret_cast<int*>(words);  // three int32 tickets in the first two words
  const int t_points = (P + kPointTile - 1) / kPointTile;
  const int t_cands = (Pc + kCandTile - 1) / kCandTile;
  unsigned long long* st_points = words + 2;
  unsigned long long* st_alloc = st_points + t_points;
  unsigned long long* st_act = st_alloc + t_cands;
  int* header = rec_ints;
  int* rec_rows = header + kHeader;
  int* rec_act = rec_rows + kRowInts * (size_t)R;
  int* rec_app = rec_act + kActInts * (size_t)Pc;
  insert_elect_kernel<<<blocks(P, INT_MAX), kThreads, 0, s>>>(
      pts, valid, P, vs, rmin, Dx, Dy, Dz, winner, num_lat, n_active, num_cand, header, words,
      nl_insert_scan_words(P, Pc));
  insert_candidate_kernel<<<blocks((long long)t_points * kThreads, kMaxBlocks), kThreads, 0, s>>>(
      pts, valid, P, vs, rmin, Dx, Dy, Dz, Pc, winner, cwinner, grid, is_surface, vox_c, cflat,
      num_cand, st_points, tickets);
  insert_alloc_kernel<<<blocks((long long)t_cands * kThreads, kMaxBlocks), kThreads, 0, s>>>(
      num_cand, Pc, cwinner, cflat, vox_c, C, lat_coords, grid, num_lat, header, rec_rows,
      st_alloc, tickets + 1);
  insert_activate_kernel<<<blocks((long long)t_cands * kThreads, kMaxBlocks), kThreads, 0, s>>>(
      num_cand, Pc, vox_c, rmin, Dx, Dy, Dz, grid, is_surface, corner_idx, append, A,
      active_ids, active_coords, grid_active, n_active, header, rec_act, rec_app, st_act,
      tickets + 2);
  if (append)
    insert_pack_kernel<<<blocks(2LL * F * std::min(Pc, A), 4 * kMaxBlocks), kThreads, 0, s>>>(
        header, F, emb, bf16, active_ids, corner_idx, packed, rec_packed);
  return (int)cudaGetLastError();
}

// Writes a record of nl_insert (R, Pc, Aa as it was made with) back into
// the tables it came from.
extern "C" int nl_insert_undo(const int* rec_ints, const float* rec_packed, int R, int Pc, int Aa,
                              int F, int* lat_coords, int* grid, unsigned char* is_surface,
                              int* corner_idx, int* active_ids, int* active_coords,
                              int* grid_active, float* packed, int* num_lat, int* n_active,
                              int* num_cand, void* stream) {
  const int* header = rec_ints;
  const int* rec_rows = header + kHeader;
  const int* rec_act = rec_rows + kRowInts * (size_t)R;
  const int* rec_app = rec_act + kActInts * (size_t)Pc;
  const long long most = std::max({(long long)R, (long long)Pc, 2LL * F * Aa});
  insert_undo_kernel<<<blocks(most, 2 * kMaxBlocks), kThreads, 0, (cudaStream_t)stream>>>(
      header, rec_rows, rec_act, rec_app, rec_packed, F, lat_coords, grid, is_surface, corner_idx,
      active_ids, active_coords, grid_active, packed, num_lat, n_active, num_cand);
  return (int)cudaGetLastError();
}
