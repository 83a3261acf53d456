// K1 / K2: the fused hits-sampler field and its backward.
//
// K1 (hits_field_fwd) replaces the XLA fusion of
//   nerfloam_tpu/ops/raycast.py:248-302  sample_from_hits,
//   nerfloam_tpu/ops/raycast.py:305-324  resolve_cells_in_hits,
//   nerfloam_tpu/core/render.py:91-105   hit_rows / select_rows,
//   nerfloam_tpu/core/render.py:72-87    field_from_embs (up to the decoder),
//   nerfloam_tpu/ops/interp.py:22-47     trilinear interpolation,
// as driven by render.py:132-147 (BA) and tracking.py:254-261 (GN).
// One block of 128 threads takes a few rays (128 / M of them, fewer where
// their tables would pass 48 KB). It stages their hit tables (aid, t_near,
// seg, cdf, cell: 28 B a slot) and the rays in shared memory with coalesced
// loads, the jitter of its first 128 samples fetched alongside. Then one
// thread per sample: stratified inverse-CDF depth by compare-count over the
// ray's H cdf entries, xyz = o + d z, the cell floor(xyz / vs) re-resolved
// against the ray's hit cells
// (the FIRST hit with that cell and aid >= 0: duplicate slabs of one cell
// carry the same aid, so JAX's one-hot average over them is this one row),
// and z, valid, aid, xyz written. Then four threads per sample interpolate:
// thread k owns features 4k..4k+3 and adds the 8 corners in order, so a
// corner's 64 B are read by four neighbouring threads and the sample's 64 B
// of features leave as four coalesced float4. Invalid samples get zero
// features and aid -1. The origin has a row stride of 3, or 0 where every
// ray shares it (the trackers), so it is never copied.
//
// K2 (hits_field_bwd) is K1's backward under jax.value_and_grad
// (core/ba.py:335) and jax.grad (core/tracking.py:214).
// d xyz: one thread per (ray, sample), from the derivative of the trilinear
// weights (the voxel center is fixed: floor has zero gradient). The
// trackers' form (no d packed) is this one launch.
// d packed (A, 128), when asked (BA), in three more launches and no torch
// op: the sample pass also counts each valid sample on its packed row (an
// integer atomic, one per row and warp: the same totals on every run) and
// stores its 8 trilinear weights; an exclusive scan of the counts (one
// pass, decoupled look-back) gives each row its segment and lists the
// touched rows; a scatter puts each valid sample's index in its row's
// segment, counting the row down again (so the next call finds zero counts
// and needs no memset); then one warp per touched row sorts its segment's
// indices ascending (a bitonic network in shared memory: the scatter's
// order is arbitrary) and adds w_corner * d feats over them in that order,
// lane L owning corner L / 4 and features 4 (L % 4)..+3, while the
// untouched rows get coalesced 512 B stores of zeros. A segment of more
// than 64 samples takes a whole block, which sorts it in shared memory (or
// in place in the index array beyond 4,096 samples: no sample is dropped)
// and fetches 256 samples at a time for warp 0 to add.
// No float atomics: the table is the same on every run, each row's sum
// rounded in ascending sample index from 0, as the plain
// render.dpacked_in_row_order_plain computes it. (Float atomics made BA's
// Adam, which normalises each entry's gradient, turn their run-to-run
// noise into different maps and trajectories.)
//
// Bound on the H100: one 512 B packed row per valid sample (K1 reads it,
// the d xyz pass reads it again; neighbouring samples share rows, so the
// reads hit L1/L2), and the dense (A, 128) d packed written once, which
// BA's Adam needs and which dominates K2's bytes.
//
// Rounding: the sample position, the cell and the trilinear weights go
// through __fmul_rn / __fadd_rn / __fdiv_rn (and -fmad=false), in the order
// of the JAX code, so z, valid and aid agree exactly with the plain torch
// version, and d packed with dpacked_in_row_order_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;        // feature width
constexpr int kRow = 8 * kF;  // packed row width
constexpr int kFwdThreads = 128;
constexpr size_t kFwdSmemDefault = 48 * 1024;  // dynamic shared memory without opting in
constexpr int kBwdThreads = 128;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;  // counts per scan tile
constexpr int kScatterThreads = 256;
constexpr int kReduceWarps = 8;
constexpr int kWarpCap = 64;     // the longest segment a warp takes; longer ones a block
// the longest segment a block sorts in shared memory; its 40 KB a block
// also caps the reduce pass at 5 blocks an SM, which spreads the blocks over
// more SMs (with 512 and 26 KB the pass ran ~15% slower on the H100)
constexpr int kBlockCap = 4096;
constexpr int kReduceGrid = 1024;
constexpr int kStage = 8 + kF;                        // a staged sample: 8 weights, d feats
constexpr unsigned long long kAggregate = 1ull << 32;  // a tile's own sum is published
constexpr unsigned long long kPrefix = 2ull << 32;     // its inclusive prefix is

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// per-axis interpolation factors: f[a][0] = 1 - p_a (corner bit 0),
// f[a][1] = p_a (corner bit 1), for p = (xyz - center) / vs + 0.5
__device__ __forceinline__ void axis_factors(const float* xyz, float vs, float f[3][2]) {
  for (int a = 0; a < 3; ++a) {
    float center = __fmul_rn(__fadd_rn(floorf(__fdiv_rn(xyz[a], vs)), 0.5f), vs);
    float p = __fadd_rn(__fdiv_rn(__fsub_rn(xyz[a], center), vs), 0.5f);
    f[a][0] = __fsub_rn(1.0f, p);
    f[a][1] = p;
  }
}

// corner jc's trilinear weight (f_x f_y) f_z from factors laid out f[2a + bit]
__device__ __forceinline__ float corner_weight(const float* f, int jc) {
  return __fmul_rn(__fmul_rn(f[(jc >> 2) & 1], f[2 + ((jc >> 1) & 1)]), f[4 + (jc & 1)]);
}

__device__ __forceinline__ void add_scaled(float4& acc, float w, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
}

// Shared memory of a K1 block per ray: its hit table (aid, t_near, seg,
// cdf and 3 cell ints a slot), per sample its aid and 6 factors, and its
// origin and direction.
inline size_t fwd_smem_per_ray(int M, int H) {
  return sizeof(float) * ((size_t)H * 7 + (size_t)M * 7 + 6);
}

__global__ void __launch_bounds__(kFwdThreads) hits_field_fwd_kernel(
    const int* __restrict__ h_aid, const float* __restrict__ h_tnear,
    const float* __restrict__ h_seg, const float* __restrict__ h_cdf, int ld,
    const int* __restrict__ h_cell, const float* __restrict__ u,
    const float* __restrict__ rays_o, int o_stride, const float* __restrict__ rays_d,
    const float* __restrict__ packed, int R, int M, int H, int rb, float vs, float lo, float hi,
    float* __restrict__ z_out, unsigned char* __restrict__ valid_out,
    int* __restrict__ aid_out, float* __restrict__ xyz_out, float* __restrict__ feats) {
  extern __shared__ float smem[];
  int* s_aid = reinterpret_cast<int*>(smem);
  float* s_tn = smem + rb * H;
  float* s_seg = s_tn + rb * H;
  float* s_cdf = s_seg + rb * H;
  int* s_cell = reinterpret_cast<int*>(s_cdf + rb * H);
  int* s_said = s_cell + rb * H * 3;
  float* s_f = reinterpret_cast<float*>(s_said + rb * M);
  float* s_ray = s_f + rb * M * 6;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, R - r0);
  const int ns = nr * M;
  const size_t i0 = (size_t)r0 * M;  // the block's first sample

  // everything a sample reads but its packed row, fetched at once: the
  // tables, the rays and (for the first pass over the samples) the jitter
  const float u_first = tid < ns ? u[i0 + tid] : 0.0f;
  for (int e = tid; e < nr * 6; e += kFwdThreads) {
    int rr = e / 6, k = e - rr * 6;
    s_ray[e] = k < 3 ? rays_o[(size_t)(r0 + rr) * o_stride + k] : rays_d[3 * (r0 + rr) + k - 3];
  }
  for (int e = tid; e < nr * H; e += kFwdThreads) {
    int rr = e / H, h = e - rr * H;
    size_t g = (size_t)(r0 + rr) * ld + h;
    s_tn[e] = h_tnear[g];
    s_seg[e] = h_seg[g];
    s_cdf[e] = h_cdf[g];
    s_aid[e] = h_aid[(size_t)r0 * H + e];
  }
  for (int e = tid; e < nr * H * 3; e += kFwdThreads) s_cell[e] = h_cell[(size_t)r0 * H * 3 + e];
  __syncthreads();

  for (int s = tid; s < ns; s += kFwdThreads) {
    int rr = s / M, m = s - rr * M;
    size_t i = i0 + s;
    const float* cdf = s_cdf + rr * H;
    float total = cdf[H - 1];
    float q = __fmul_rn(__fdiv_rn(__fadd_rn((float)m, s == tid ? u_first : u[i]), (float)M),
                        total);
    int j = 0;
    for (int h = 0; h < H; ++h) j += cdf[h] < q;
    j = min(j, H - 1);
    float cdf_j = cdf[j], seg_j = s_seg[rr * H + j], tn_j = s_tn[rr * H + j];
    int aid_j = s_aid[rr * H + j];
    float frac = clampf(
        __fdiv_rn(__fsub_rn(q, __fsub_rn(cdf_j, seg_j)), seg_j > 0.0f ? seg_j : 1.0f), 0.0f,
        1.0f);
    float z = __fadd_rn(tn_j, __fmul_rn(clampf(frac, lo, hi), seg_j));
    bool pvalid = total > 0.0f && aid_j >= 0 && seg_j > 0.0f;
    if (!pvalid) z = 0.0f;

    float xyz[3];
    int c[3];
    for (int a = 0; a < 3; ++a) {
      xyz[a] = __fadd_rn(s_ray[rr * 6 + a], __fmul_rn(s_ray[rr * 6 + 3 + a], z));
      c[a] = (int)floorf(__fdiv_rn(xyz[a], vs));
      xyz_out[3 * i + a] = xyz[a];
    }
    int aid = -1;
    for (int h = 0; h < H; ++h) {
      const int* hc = s_cell + (rr * H + h) * 3;
      int ah = s_aid[rr * H + h];
      if (ah >= 0 && hc[0] == c[0] && hc[1] == c[1] && hc[2] == c[2]) {
        aid = ah;
        break;
      }
    }
    bool valid = pvalid && aid >= 0;
    z_out[i] = z;
    valid_out[i] = valid;
    aid_out[i] = valid ? aid : -1;
    s_said[s] = valid ? aid : -1;
    if (valid) {
      float f[3][2];
      axis_factors(xyz, vs, f);
      for (int a = 0; a < 3; ++a) {
        s_f[s * 6 + 2 * a] = f[a][0];
        s_f[s * 6 + 2 * a + 1] = f[a][1];
      }
    }
  }
  __syncthreads();

  float4* out = reinterpret_cast<float4*>(feats) + i0 * (kF / 4);
  for (int t = tid; t < ns * 4; t += kFwdThreads) {
    int s = t >> 2, k4 = t & 3;
    int aid = s_said[s];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (aid >= 0) {
      const float* f = s_f + s * 6;
      const float4* row = reinterpret_cast<const float4*>(packed + (size_t)aid * kRow) + k4;
      for (int jc = 0; jc < 8; ++jc) add_scaled(acc, corner_weight(f, jc), row[jc * (kF / 4)]);
    }
    out[t] = acc;
  }
}

// d xyz per sample and, when counts is given (the d-packed form), the
// sample's 8 trilinear weights and its count on its packed row (blockDim
// a multiple of 32: the whole warp takes part in the count)
__global__ void __launch_bounds__(kBwdThreads) hits_field_bwd_kernel(
    const float* __restrict__ dfeats, const float* __restrict__ xyz_in,
    const int* __restrict__ aid_in, const unsigned char* __restrict__ valid_in,
    const float* __restrict__ packed, int n, float vs, float* __restrict__ dxyz,
    int* __restrict__ counts, float* __restrict__ wts, int* __restrict__ n_listed) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0 && n_listed != nullptr) n_listed[0] = n_listed[1] = 0;  // the last call's lists
  const bool valid = i < n && valid_in[i];
  const int aid = valid ? aid_in[i] : -1;
  if (counts != nullptr) {  // one count atomic per row and warp: its lanes' samples at once
    const unsigned peers = __match_any_sync(0xffffffffu, aid);
    if (aid >= 0 && __ffs(peers) - 1 == (int)(threadIdx.x & 31))
      atomicAdd(counts + aid, __popc(peers));
  }
  if (i >= n) return;
  float g[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    float xyz[3] = {xyz_in[3 * i], xyz_in[3 * i + 1], xyz_in[3 * i + 2]};
    float f[3][2];
    axis_factors(xyz, vs, f);
    float df[kF];
    const float4* dsrc = reinterpret_cast<const float4*>(dfeats + (size_t)i * kF);
    for (int k4 = 0; k4 < kF / 4; ++k4) {
      float4 v = dsrc[k4];
      df[4 * k4] = v.x;
      df[4 * k4 + 1] = v.y;
      df[4 * k4 + 2] = v.z;
      df[4 * k4 + 3] = v.w;
    }
    const float4* row = reinterpret_cast<const float4*>(packed + (size_t)aid * kRow);
    for (int jc = 0; jc < 8; ++jc) {
      int b0 = (jc >> 2) & 1, b1 = (jc >> 1) & 1, b2 = jc & 1;
      float f0 = f[0][b0], f1 = f[1][b1], f2 = f[2][b2];
      // d(row_j . dfeats) weighted by d w_j / d p_a = sign_a * (other two factors);
      // the row comes in 16 B loads, the dot is still added k = 0..15 in order
      float dot = 0.0f;
      for (int k4 = 0; k4 < kF / 4; ++k4) {
        float4 v = row[jc * (kF / 4) + k4];
        dot += v.x * df[4 * k4];
        dot += v.y * df[4 * k4 + 1];
        dot += v.z * df[4 * k4 + 2];
        dot += v.w * df[4 * k4 + 3];
      }
      g[0] += (b0 ? dot : -dot) * f1 * f2;
      g[1] += (b1 ? dot : -dot) * f0 * f2;
      g[2] += (b2 ? dot : -dot) * f0 * f1;
    }
    for (int a = 0; a < 3; ++a) g[a] = __fdiv_rn(g[a], vs);
    if (counts != nullptr) {
      const float fl[6] = {f[0][0], f[0][1], f[1][0], f[1][1], f[2][0], f[2][1]};
      float w[8];
      for (int jc = 0; jc < 8; ++jc) w[jc] = corner_weight(fl, jc);
      float4* wd = reinterpret_cast<float4*>(wts + (size_t)i * 8);
      wd[0] = make_float4(w[0], w[1], w[2], w[3]);
      wd[1] = make_float4(w[4], w[5], w[6], w[7]);
    }
  }
  for (int a = 0; a < 3; ++a) dxyz[3 * i + a] = g[a];
}

// Exclusive scan of counts (A,) into offsets (A + 1,), offsets[A] the
// total, in one pass: each block takes the next tile (a ticket from
// *ticket), publishes its tile's sum, looks back over its predecessors'
// published sums until one has published its inclusive prefix, and
// publishes its own. The tile states and the ticket are zero on entry (the
// scatter pass zeroes them again). It also lists the touched rows, in no
// particular order: rows with 1..kWarpCap samples after n_listed[0] in
// `touched`, longer ones after n_listed[1] in `long_rows` (the counters
// zero on entry: the sample pass zeroes them).
__global__ void __launch_bounds__(kScanThreads) hits_field_scan_kernel(
    const int* __restrict__ counts, int A, int* __restrict__ offsets,
    unsigned long long* tile_state, int* ticket, int* __restrict__ n_listed,
    int* __restrict__ touched, int* __restrict__ long_rows) {
  __shared__ int s_vals[kScanTile];
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_warp_rows[kScanThreads / 32];
  __shared__ int s_tile, s_prefix, s_rows, s_long;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kScanTile;
  for (int k = 0; k < kScanItems; ++k) {
    int e = k * kScanThreads + tid;
    s_vals[e] = base + e < A ? counts[base + e] : 0;
  }
  __syncthreads();
  int local[kScanItems];
  int sum = 0, rows = 0;
  for (int k = 0; k < kScanItems; ++k) {
    int c = s_vals[tid * kScanItems + k];
    local[k] = sum;
    sum += c;
    rows += c > kWarpCap ? 1 << 16 : c > 0;  // touched rows, long ones in the high half
  }
  int incl = sum, rows_incl = rows;
  for (int d = 1; d < 32; d <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, incl, d);
    int r = __shfl_up_sync(0xffffffffu, rows_incl, d);
    if (lane >= d) {
      incl += v;
      rows_incl += r;
    }
  }
  if (lane == 31) {
    s_warp[warp] = incl;
    s_warp_rows[warp] = rows_incl;
  }
  __syncthreads();
  int before = 0, agg = 0, rows_before = 0, rows_agg = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    agg += s_warp[w];
    rows_before += w < warp ? s_warp_rows[w] : 0;
    rows_agg += s_warp_rows[w];
  }
  if (tid == kScanThreads - 1) {
    s_rows = atomicAdd(n_listed, rows_agg & 0xffff);
    s_long = atomicAdd(n_listed + 1, rows_agg >> 16);
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
        while (__any_sync(0xffffffffu, (v >> 32) == 0))   // not all published yet
          if ((v >> 32) == 0) v = st[p];
        // add back to the nearest predecessor that has its inclusive prefix
        const unsigned has = __ballot_sync(0xffffffffu, (v & ~0xffffffffull) == kPrefix);
        const int stop = has ? __ffs(has) - 1 : 31;
        int part = lane <= stop ? (int)(unsigned)v : 0;
        for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
        excl += part;
        if (has) break;
      }
    }
    if (lane == 0) {
      atomicExch(tile_state + tile, kPrefix | (unsigned)(excl + agg));
      s_prefix = excl;
      if (base + kScanTile >= A) offsets[A] = excl + agg;  // the last tile
    }
  }
  __syncthreads();
  const int mine = rows_before + rows_incl - rows;
  int at = s_rows + (mine & 0xffff), at_long = s_long + (mine >> 16);
  for (int k = 0; k < kScanItems; ++k) {
    int c = s_vals[tid * kScanItems + k];
    if (c > kWarpCap)
      long_rows[at_long++] = base + tid * kScanItems + k;
    else if (c > 0)
      touched[at++] = base + tid * kScanItems + k;
  }
  __syncthreads();
  const int start = s_prefix + before + incl - sum;
  for (int k = 0; k < kScanItems; ++k) s_vals[tid * kScanItems + k] = start + local[k];
  __syncthreads();
  for (int k = 0; k < kScanItems; ++k) {
    int e = k * kScanThreads + tid;
    if (base + e < A) offsets[base + e] = s_vals[e];
  }
}

// Each valid sample's index into its row's segment (in no particular order
// within it), counting the row back down to zero; block 0 zeroes the scan's
// tile states and ticket for the next call.
__global__ void __launch_bounds__(kScatterThreads) hits_field_scatter_kernel(
    const int* __restrict__ aid_in, const unsigned char* __restrict__ valid_in, int n,
    int* __restrict__ counts, const int* __restrict__ offsets, int* __restrict__ ids,
    unsigned long long* __restrict__ tile_state, int n_tiles, int* __restrict__ ticket) {
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) tile_state[t] = 0;
    if (threadIdx.x == 0) *ticket = 0;
  }
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && valid_in[i]) {
    int a = aid_in[i];
    ids[offsets[a] + atomicSub(counts + a, 1) - 1] = i;
  }
}

// Ascending sort of keys[0, L) by t of nt threads (a warp, or the block):
// a bitonic network whose merges compare each element with its mirror, so
// that every comparator puts the smaller key first and a missing partner
// (index >= L) stands for +infinity and needs no exchange.
template <bool kBlock>
__device__ void sort_keys(int* keys, int L, int t, int nt) {
  int P = 1, lp = 0;
  while (P < L) {
    P <<= 1;
    ++lp;
  }
  for (int lk = 1; lk <= lp; ++lk) {      // merges of 2^lk keys
    for (int ld = lk - 1; ld >= 0; --ld) {  // comparators 2^ld apart
      const int d = 1 << ld;
      for (int x = t; x < P / 2; x += nt) {
        int lo = ((x >> ld) << (ld + 1)) | (x & (d - 1));
        int hi = ld == lk - 1 ? lo ^ ((1 << lk) - 1) : lo | d;  // the mirror, or lo + d
        if (hi < L) {
          int a = keys[lo], b = keys[hi];
          if (a > b) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
      }
      if (kBlock) __syncthreads(); else __syncwarp();
    }
  }
}

// One row's d packed by a warp: the sorted sample indices S[0, L), lane
// `lane` adding w[corner] * d feats[4 q..4 q + 3] over them in order. The
// samples' weights and d feats come in 32 at a time, each lane fetching one
// sample's 96 B into the warp's stage (32 x 24 floats), so a long row waits
// for memory once per 32 samples and not once per sample.
__device__ __forceinline__ float4 row_sum(const int* S, int L, const float* __restrict__ wts,
                                          const float4* __restrict__ df4, int lane,
                                          float* stage) {
  const int c = lane >> 2, q = lane & 3;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4* mine = reinterpret_cast<float4*>(stage + lane * kStage);
  for (int base = 0; base < L; base += 32) {
    const int cnt = min(32, L - base);
    if (lane < cnt) {
      const int i = S[base + lane];
      const float4* w4 = reinterpret_cast<const float4*>(wts + (size_t)i * 8);
      const float4* d4 = df4 + (size_t)i * 4;
      float4 v0 = w4[0], v1 = w4[1], v2 = d4[0], v3 = d4[1], v4 = d4[2], v5 = d4[3];
      mine[0] = v0;
      mine[1] = v1;
      mine[2] = v2;
      mine[3] = v3;
      mine[4] = v4;
      mine[5] = v5;
    }
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < cnt; ++k)
      add_scaled(acc, stage[k * kStage + c],
                 reinterpret_cast<const float4*>(stage + k * kStage + 8)[q]);
    __syncwarp();
  }
  return acc;
}

// d packed (A, 128), three kinds of rows: a row of more than kWarpCap
// samples takes a whole block (first, the loop the same for every thread of
// a block): the block sorts its indices, stages 256 samples at a time and
// warp 0 adds them; a touched row a warp; the untouched rows get their
// zeros 32 rows at a time, a coalesced 512 B store each, one offsets load
// for all 32.
__global__ void __launch_bounds__(kReduceWarps * 32) hits_field_reduce_kernel(
    const int* __restrict__ offsets, int* ids, const float* __restrict__ wts,
    const float* __restrict__ dfeats, int A, const int* __restrict__ n_listed,
    const int* __restrict__ touched, const int* __restrict__ long_rows,
    float* __restrict__ dpacked) {
  constexpr int kThreads = kReduceWarps * 32;
  __shared__ int s_keys[kBlockCap];
  __shared__ __align__(16) float s_stage[kThreads * kStage];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* df4 = reinterpret_cast<const float4*>(dfeats);
  float4* out = reinterpret_cast<float4*>(dpacked);
  int* mine = s_keys + warp * kWarpCap;
  float* stage = s_stage + warp * 32 * kStage;
  const int n_touched = n_listed[0], n_long = n_listed[1];
  const int n_warps = gridDim.x * kReduceWarps;
  for (int t = blockIdx.x; t < n_long; t += gridDim.x) {
    const int a = long_rows[t];
    const int st = offsets[a], len = offsets[a + 1] - st;
    int* keys = len <= kBlockCap ? s_keys : ids + st;
    if (len <= kBlockCap)
      for (int p = tid; p < len; p += kThreads) s_keys[p] = ids[st + p];
    __syncthreads();
    sort_keys<true>(keys, len, tid, kThreads);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = 0; base < len; base += kThreads) {
      const int cnt = min(kThreads, len - base);
      if (tid < cnt) {
        const int i = keys[base + tid];
        const float4* w4 = reinterpret_cast<const float4*>(wts + (size_t)i * 8);
        const float4* d4 = df4 + (size_t)i * 4;
        float4* dst = reinterpret_cast<float4*>(s_stage + tid * kStage);
        float4 v0 = w4[0], v1 = w4[1], v2 = d4[0], v3 = d4[1], v4 = d4[2], v5 = d4[3];
        dst[0] = v0;
        dst[1] = v1;
        dst[2] = v2;
        dst[3] = v3;
        dst[4] = v4;
        dst[5] = v5;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll 4
        for (int k = 0; k < cnt; ++k)
          add_scaled(acc, s_stage[k * kStage + (lane >> 2)],
                     reinterpret_cast<const float4*>(s_stage + k * kStage + 8)[lane & 3]);
      }
      __syncthreads();
    }
    if (warp == 0) out[(size_t)a * 32 + lane] = acc;
  }
  for (int t = blockIdx.x * kReduceWarps + warp; t < n_touched; t += n_warps) {
    const int a = touched[t];
    const int st = offsets[a], L = offsets[a + 1] - st;
    for (int p = lane; p < L; p += 32) mine[p] = ids[st + p];
    __syncwarp();
    sort_keys<false>(mine, L, lane, 32);
    out[(size_t)a * 32 + lane] = row_sum(mine, L, wts, df4, lane, stage);
    __syncwarp();
  }
  for (int c = blockIdx.x * kReduceWarps + warp; c * 32 < A; c += n_warps) {
    const int a = c * 32 + lane;
    unsigned zero = __ballot_sync(0xffffffffu, a < A && offsets[a + 1] == offsets[a]);
    while (zero) {
      const int r = __ffs(zero) - 1;
      zero &= zero - 1;
      out[((size_t)c * 32 + r) * 32 + lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

}  // namespace

// The d-packed form's scan: its tiles (and tile states) for A rows
extern "C" int nl_hits_field_scan_tiles(int A) { return (A + kScanTile - 1) / kScanTile; }

// ld: the row stride of t_near, seg and cdf (H, or more where they are
// views of a wider table); o_stride: rays_o's row stride (3, or 0)
extern "C" int nl_hits_field_fwd(const int* h_aid, const float* h_tnear, const float* h_seg,
                                 const float* h_cdf, int ld, const int* h_cell, const float* u,
                                 const float* rays_o, int o_stride, const float* rays_d,
                                 const float* packed, int R, int M, int H, float vs, float lo,
                                 float hi, float* z, unsigned char* valid, int* aid, float* xyz,
                                 float* feats, void* stream) {
  if (R <= 0 || M <= 0) return (int)cudaGetLastError();
  // as many rays as give each thread a sample, and as fit in the default
  // 48 KB; one ray's tables beyond that ask for more (up to the card's)
  const size_t per_ray = fwd_smem_per_ray(M, H);
  const size_t fit = kFwdSmemDefault / per_ray;
  int rb = M >= kFwdThreads ? 1 : kFwdThreads / M;
  if ((size_t)rb > fit) rb = fit > 0 ? (int)fit : 1;
  const size_t smem = rb * per_ray;
  if (smem > kFwdSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(hits_field_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  hits_field_fwd_kernel<<<(R + rb - 1) / rb, kFwdThreads, smem, (cudaStream_t)stream>>>(
      h_aid, h_tnear, h_seg, h_cdf, ld, h_cell, u, rays_o, o_stride, rays_d, packed, R, M, H, rb,
      vs, lo, hi, z, valid, aid, xyz, feats);
  return (int)cudaGetLastError();
}

// d xyz (n, 3); then, if dpacked is not null, d packed (A, 128) through the
// scratch: tile_state (int64, at least the scan's tiles, zero), the ticket
// (zero), counts (A, zero), offsets (A + 1), ids (n), wts (n, 8), and rows:
// the two list counters, then the touched rows (A) and the long rows (A).
// States, ticket and counts are zero again when the call ends.
extern "C" int nl_hits_field_bwd(const float* dfeats, const float* xyz, const int* aid,
                                 const unsigned char* valid, const float* packed, int n,
                                 float vs, float* dxyz, int A, float* dpacked,
                                 unsigned long long* tile_state, int* ticket, int* counts,
                                 int* offsets, int* ids, float* wts, int* rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool dp = dpacked != nullptr && A > 0;
  if (n > 0 || dp)
    hits_field_bwd_kernel<<<n > 0 ? (n + kBwdThreads - 1) / kBwdThreads : 1, kBwdThreads, 0, s>>>(
        dfeats, xyz, aid, valid, packed, n, vs, dxyz, dp ? counts : nullptr, wts,
        dp ? rows : nullptr);
  if (dp) {
    int tiles = nl_hits_field_scan_tiles(A);
    hits_field_scan_kernel<<<tiles, kScanThreads, 0, s>>>(counts, A, offsets, tile_state, ticket,
                                                          rows, rows + 2, rows + 2 + A);
    int blocks = n > 0 ? (n + kScatterThreads - 1) / kScatterThreads : 1;
    hits_field_scatter_kernel<<<blocks, kScatterThreads, 0, s>>>(aid, valid, n, counts, offsets,
                                                                 ids, tile_state, tiles, ticket);
    int grid = (A + 16 * kReduceWarps - 1) / (16 * kReduceWarps);  // two warps per 32 rows
    hits_field_reduce_kernel<<<grid < kReduceGrid ? grid : kReduceGrid, kReduceWarps * 32, 0, s>>>(
        offsets, ids, wts, dfeats, A, rows, rows + 2, rows + 2 + A, dpacked);
  }
  return (int)cudaGetLastError();
}
