// K5: fold one BA step's packed-copy deltas back into the canonical
// embeddings (port of nerfloam_tpu/map/voxel_map.py:233-287
// reconcile_packed, "mean" or "sum" mode, and 290-298 bump_upd_count; the repack,
// 301-308 pack_embeddings, is the pack pass of csrc/active_set.cu), as the
// tail of core/ba.py:378-391 calls them.
//
// Three passes (then the pack pass), on a scratch the caller keeps
// between calls: a (C,) head table held at -1, and the scan's tile states
// and ticket held at zero.
//   scan    one pass over the touched mask by tiles of kScanTile rows, a
//           decoupled look-back giving each tile its prefix (each block
//           takes the next tile from a ticket, publishes its count, adds
//           its predecessors' back to one that has published its
//           inclusive prefix). A touched row a of rank r bumps
//           upd_count[active_ids[a]]; when r < T (touched_cap) it takes
//           slot r of the compacted lists t_rows (a) and t_ids (its
//           voxel). The last tile writes the true touched count (it may
//           exceed T).
//   link    one thread per contribution i = 8 r + k (kept row r, corner
//           slot k, corner c = corner_idx[t_ids[r]][k]): i is pushed onto
//           c's list with atomicExch on head[c].
//   fold    one thread per contribution; only the thread of the
//           contribution at the head of its corner's list goes on (and
//           sets head[c] = -1: any other contribution of c reads head[c]
//           only to learn that it is not the head, so a reset entry still
//           sends it home). It walks the list into registers: distinct
//           active rows give at most 8 entries, a lattice corner belonging
//           to at most 8 voxels. A fixed sorting network puts them in
//           ascending i, i.e. ascending (rank, corner slot); for each in
//           turn it loads the 16 features of new and old packed (16-byte
//           loads) and adds each delta (new - old) / k ("mean"; "sum"
//           divides by 1, which is exact), cast to the embedding type
//           BEFORE the add as JAX does, rounding after every add, into
//           the corner's 16 features. A longer list
//           (duplicate active rows) takes the ordered walk instead. Block
//           0 zeroes the scan's tile states and ticket.
// The list order from atomicExch varies from run to run; the sorted order
// does not, so two calls give bit-identical tables, and they equal a
// sequential index_add_ in index order (the plain twin on the CPU).
// On the H100 a half-warp per contribution (16x the threads, most of them
// only learning that they are not a head) took about as long as a thread
// per feature; a thread per contribution takes less, and the scattered
// 64-byte row loads of the walk, not the exact rounding, take most of it.
//
// Bound on the H100: at the bench shapes T = 20,480-32,768 touched rows of
// A = 73,728-131,072: the touched mask and active ids, the two (T, 128)
// f32 delta rows per kept voxel (old and new packed), its corner ids, 8 x
// 16 embedding reads and writes per kept voxel, the count bumps; the
// repack (csrc/active_set.cu) then writes the (A, 128) f32 table. The
// whole-map head reset of a fresh scratch (8 MB at C = 2,097,152) is paid
// once per scratch, not per call.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;
constexpr int kRow = 8 * kF;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // touched flags per scan tile
constexpr int kLinkThreads = 256;
constexpr int kFoldThreads = 128;
constexpr int kMaxList = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // a tile's own count is published
constexpr unsigned long long kPrefix = 2ull << 32;     // its inclusive prefix is

__global__ void __launch_bounds__(kScanThreads) reconcile_scan_kernel(
    const unsigned char* __restrict__ touched, const int* __restrict__ active_ids, int A, int T,
    int* __restrict__ upd_count, int* __restrict__ count, int* __restrict__ t_rows,
    int* __restrict__ t_ids, unsigned long long* tile_state, int* ticket) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_tile, s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kScanTile;
  const int a0 = base + tid * kScanItems;  // this thread's rows a0 .. a0 + kScanItems - 1
  unsigned flags = 0;
  int mine = 0;
  for (int k = 0; k < kScanItems; ++k) {
    const bool t = a0 + k < A && touched[a0 + k];
    flags |= (unsigned)t << k;
    mine += t;
  }
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
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
      s_prefix = excl;
      if (base + kScanTile >= A) *count = excl + agg;  // the last tile
    }
  }
  __syncthreads();
  int r = s_prefix + before + incl - mine;  // the rank of this thread's first touched row
  for (int k = 0; k < kScanItems; ++k, flags >>= 1) {
    if (!(flags & 1u)) continue;
    const int a = a0 + k;
    const int id = active_ids[a];
    atomicAdd(upd_count + id, 1);
    if (r < T) {
      t_rows[r] = a;
      t_ids[r] = id;
    }
    ++r;
  }
}

__global__ void __launch_bounds__(kLinkThreads) reconcile_link_kernel(
    const int* __restrict__ count, int T, int C, const int* __restrict__ t_ids,
    const int* __restrict__ corner_idx, int* __restrict__ cid, int* __restrict__ next,
    int* head) {
  const int i = blockIdx.x * kLinkThreads + threadIdx.x;
  if (i >= 8 * min(*count, T)) return;
  int c = corner_idx[8 * (size_t)t_ids[i >> 3] + (i & 7)];
  if (c >= C) c = -1;
  cid[i] = c;
  if (c >= 0) next[i] = atomicExch(head + c, i);
}

template <typename Emb>
__device__ __forceinline__ float to_f(Emb v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Emb>
__device__ __forceinline__ Emb from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc + (new - old) / k, the delta cast to the embedding type before the
// add and the sum rounded to it after
template <typename Emb>
__device__ __forceinline__ float fold(float acc, float nv, float ov, float kf) {
  const float d = __fdiv_rn(__fsub_rn(nv, ov), kf);
  return to_f<Emb>(from_f<Emb>(__fadd_rn(acc, to_f<Emb>(from_f<Emb>(d)))));
}

__device__ __forceinline__ void order(int& x, int& y) {
  const int lo = min(x, y), hi = max(x, y);
  x = lo;
  y = hi;
}

// a corner's kF features, read and written 16 bytes at a time
__device__ __forceinline__ void load_row(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < kF / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
  }
}
__device__ __forceinline__ void store_row(float* p, const float* v) {
#pragma unroll
  for (int q = 0; q < kF / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                  v[4 * q + 3]);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int q = 0; q < kF / 8; ++q) {
    const uint4 x = reinterpret_cast<const uint4*>(p)[q];
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[8 * q + 2 * h] = __uint_as_float(w[h] << 16);
      v[8 * q + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int q = 0; q < kF / 8; ++q) {
    unsigned w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      w[h] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[8 * q + 2 * h])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[8 * q + 2 * h + 1])) << 16);
    reinterpret_cast<uint4*>(p)[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// contribution e's delta folded into the corner's features: ascending e
// is the order of the adds
template <typename Emb>
__device__ __forceinline__ void fold_entry(float* acc, int e, float kf,
                                           const int* __restrict__ t_rows,
                                           const float* __restrict__ new_packed,
                                           const float* __restrict__ old_packed) {
  const size_t off = (size_t)t_rows[e >> 3] * kRow + (e & 7) * kF;
  float nv[kF], ov[kF];
  load_row(new_packed + off, nv);
  load_row(old_packed + off, ov);
#pragma unroll
  for (int f = 0; f < kF; ++f) acc[f] = fold<Emb>(acc[f], nv[f], ov[f], kf);
}

template <typename Emb>
__device__ __forceinline__ void fold_corner(int i, int c, bool sum_mode,
                                            const int* __restrict__ t_rows,
                                            const int* __restrict__ next,
                                            const float* __restrict__ new_packed,
                                            const float* __restrict__ old_packed,
                                            Emb* __restrict__ emb) {
  float acc[kF];
  load_row(emb + (size_t)c * kF, acc);
  int e[kMaxList];
  int p = i, k = 0;
#pragma unroll
  for (int j = 0; j < kMaxList; ++j) {
    e[j] = p >= 0 ? p : INT_MAX;  // absent entries sort last
    if (p >= 0) {
      ++k;
      p = next[p];
    }
  }
  if (p < 0) {  // at most kMaxList contributions
    order(e[0], e[2]), order(e[1], e[3]), order(e[4], e[6]), order(e[5], e[7]);
    order(e[0], e[4]), order(e[1], e[5]), order(e[2], e[6]), order(e[3], e[7]);
    order(e[0], e[1]), order(e[2], e[3]), order(e[4], e[5]), order(e[6], e[7]);
    order(e[2], e[4]), order(e[3], e[5]);
    order(e[1], e[4]), order(e[3], e[6]);
    order(e[1], e[2]), order(e[3], e[4]), order(e[5], e[6]);
    const float kf = sum_mode ? 1.f : (float)k;
#pragma unroll
    for (int j = 0; j < kMaxList; ++j)
      if (j < k) fold_entry<Emb>(acc, e[j], kf, t_rows, new_packed, old_packed);
  } else {  // a longer list: count it, then apply it in ascending i, one walk per entry
    for (; p >= 0; p = next[p]) ++k;
    const float kf = sum_mode ? 1.f : (float)k;
    int last = -1;
    for (int n = 0; n < k; ++n) {
      int cur = INT_MAX;  // the smallest entry above the last one applied
      for (int q = i; q >= 0; q = next[q])
        if (q > last && q < cur) cur = q;
      last = cur;
      fold_entry<Emb>(acc, cur, kf, t_rows, new_packed, old_packed);
    }
  }
  store_row(emb + (size_t)c * kF, acc);
}

template <typename Emb>
__global__ void __launch_bounds__(kFoldThreads) reconcile_fold_kernel(
    const int* __restrict__ count, int T, int sum_mode, const int* __restrict__ t_rows,
    const int* __restrict__ cid, const int* __restrict__ next, int* head,
    const float* __restrict__ new_packed, const float* __restrict__ old_packed,
    Emb* __restrict__ emb, unsigned long long* __restrict__ tile_state, int n_tiles,
    int* __restrict__ ticket) {
  if (blockIdx.x == 0) {  // the scan's states, for the next call
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) tile_state[t] = 0;
    if (threadIdx.x == 0) *ticket = 0;
  }
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;  // contribution
  if (i >= 8 * min(*count, T)) return;
  const int c = cid[i];
  if (c < 0 || head[c] != i) return;  // not the head of its corner's list
  head[c] = -1;                       // for the next call
  fold_corner<Emb>(i, c, sum_mode != 0, t_rows, next, new_packed, old_packed, emb);
}

}  // namespace

extern "C" int nl_reconcile_scan_tiles(int A) {
  return A > 0 ? (A + kScanTile - 1) / kScanTile : 1;
}

// upd_count and emb are updated in place: the wrapper hands in fresh
// copies (16-byte aligned rows). head (C,) must hold -1 and tile_state
// (nl_reconcile_scan_tiles) and ticket 0 on entry; both are left so.
// t_rows and t_ids (T,), cid and next (8T,) are scratch; count (1,)
// receives the touched count. sum_mode 0: "mean", else "sum".
extern "C" int nl_reconcile(const unsigned char* touched, const int* active_ids,
                            const int* corner_idx, const float* new_packed,
                            const float* old_packed, int A, int T, int C, void* emb, int bf16,
                            int sum_mode, int* upd_count, int* count, int* head,
                            void* tile_state, int* ticket, int* t_rows, int* t_ids, int* cid,
                            int* next, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = nl_reconcile_scan_tiles(A);
  auto* states = static_cast<unsigned long long*>(tile_state);
  reconcile_scan_kernel<<<tiles, kScanThreads, 0, s>>>(touched, active_ids, A, T, upd_count,
                                                       count, t_rows, t_ids, states, ticket);
  const int n = 8 * T;  // contributions at most
  if (n > 0)
    reconcile_link_kernel<<<(n + kLinkThreads - 1) / kLinkThreads, kLinkThreads, 0, s>>>(
        count, T, C, t_ids, corner_idx, cid, next, head);
  const int blocks = n > 0 ? (n + kFoldThreads - 1) / kFoldThreads : 1;
  if (bf16)
    reconcile_fold_kernel<__nv_bfloat16><<<blocks, kFoldThreads, 0, s>>>(
        count, T, sum_mode, t_rows, cid, next, head, new_packed, old_packed,
        static_cast<__nv_bfloat16*>(emb), states, tiles, ticket);
  else
    reconcile_fold_kernel<float><<<blocks, kFoldThreads, 0, s>>>(
        count, T, sum_mode, t_rows, cid, next, head, new_packed, old_packed,
        static_cast<float*>(emb), states, tiles, ticket);
  return (int)cudaGetLastError();
}
