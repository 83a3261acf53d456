// E1's transpose: d embeddings (C, F) f32 from d packed (A, 8F) f32 (port
// of the scatter-add XLA emits for the gather of
// nerfloam_tpu/map/voxel_map.py:301-308 pack_embeddings under
// jax.value_and_grad at core/ba.py:222-227, the exact-gradient BA path).
// E1's forward is the pack pass of csrc/active_set.cu.
//
// Entry e = 8 a + s is slot s of active row a < n = min(n_active, A); its
// corner is c = max(corner_idx[8 active_ids[a] + s], 0) (a -1 corner reads
// row 0, as the pack pass does) and its gradient row is d_packed[16 e ..
// 16 e + 15]. The rows at or past n are padding: no sample reaches them
// (grid_active never points there), so their d packed is +0.0 and they
// are left out. d_emb[c] is the sum of its entries' rows in ascending e,
// i.e. ascending (row, slot), from 0, rounded after every add: the order
// XLA's CPU scatter applies its updates in.
//
// The corner -> entries map depends only on active_ids and corner_idx,
// fixed for a whole BA step, so it is built once a step into a scratch
// the caller keeps (two launches), and each backward is one launch:
//   link    one thread per entry: e pushed onto its corner's list with
//           atomicExch on head[c] (head (C,) held at -1 between builds);
//   order   one thread per corner: its list, whose order from atomicExch
//           varies from run to run, rewritten in ascending e into a second
//           list (shead, snext), and head[c] reset to -1. A list of at
//           most 8 (a lattice corner belongs to at most 8 voxels) is
//           sorted in registers by a fixed network, K5's; a longer one
//           (duplicate active rows, or -1 corners clamped to row 0) by one
//           walk per entry, never dropped;
//   grad    four threads per corner, a float4 of its 16 features each:
//           walk the sorted list and add each entry's 16-byte piece of
//           d packed, then store the row (zeros for a corner with no
//           entry, so no fill is needed). No float atomics: two calls give
//           bit-identical tables, equal to a sequential index-order add
//           (pack_embeddings_vjp_plain).
//
// Bound on the H100, per backward: read d packed for the n active rows
// (n x 512 B), the sorted heads (C x 4 B) and links (8 n x 4 B), write
// C x 16 x 4 B. At C = 2,097,152 and n ~ 65,000: ~34 MB read, 134 MB
// written.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kF = 16;
constexpr int kThreads = 256;
constexpr int kMaxList = 8;

__global__ void __launch_bounds__(kThreads) pack_grad_link_kernel(
    const int* __restrict__ active_ids, const int* __restrict__ corner_idx,
    const int* __restrict__ n_active, int A, int C, int* head, int* __restrict__ next) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 8 * min(*n_active, A)) return;
  const int c = max(corner_idx[8 * (size_t)active_ids[e >> 3] + (e & 7)], 0);
  if (c >= C) return;  // no such row: dropped, as the plain version drops it
  next[e] = atomicExch(head + c, e);
}

__device__ __forceinline__ void order(int& x, int& y) {
  const int lo = min(x, y), hi = max(x, y);
  x = lo;
  y = hi;
}

__global__ void __launch_bounds__(kThreads) pack_grad_order_kernel(
    int C, int* head, const int* __restrict__ next, int* __restrict__ shead,
    int* __restrict__ snext) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int h = head[c];
  if (h < 0) {
    shead[c] = -1;
    return;
  }
  head[c] = -1;  // for the next build
  int e[kMaxList];
  int p = h, k = 0;
#pragma unroll
  for (int j = 0; j < kMaxList; ++j) {
    e[j] = p >= 0 ? p : INT_MAX;  // absent entries sort last
    if (p >= 0) {
      ++k;
      p = next[p];
    }
  }
  if (p < 0) {  // at most kMaxList entries
    order(e[0], e[2]), order(e[1], e[3]), order(e[4], e[6]), order(e[5], e[7]);
    order(e[0], e[4]), order(e[1], e[5]), order(e[2], e[6]), order(e[3], e[7]);
    order(e[0], e[1]), order(e[2], e[3]), order(e[4], e[5]), order(e[6], e[7]);
    order(e[2], e[4]), order(e[3], e[5]);
    order(e[1], e[4]), order(e[3], e[6]);
    order(e[1], e[2]), order(e[3], e[4]), order(e[5], e[6]);
    shead[c] = e[0];
#pragma unroll
    for (int j = 0; j < kMaxList - 1; ++j)
      if (j < k) snext[e[j]] = j + 1 < k ? e[j + 1] : -1;
    if (k == kMaxList) snext[e[kMaxList - 1]] = -1;
  } else {  // a longer list: the smallest entry above the last one linked, one walk each
    int last = -1, prev = -1;
    for (;;) {
      int cur = INT_MAX;
      for (int q = h; q >= 0; q = next[q])
        if (q > last && q < cur) cur = q;
      if (cur == INT_MAX) break;
      if (prev < 0)
        shead[c] = cur;
      else
        snext[prev] = cur;
      prev = last = cur;
    }
    snext[prev] = -1;
  }
}

__global__ void __launch_bounds__(kThreads) pack_grad_kernel(
    const float4* __restrict__ d_packed, const int* __restrict__ shead,
    const int* __restrict__ snext, int C, float4* __restrict__ d_emb) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= 4LL * C) return;
  const int c = (int)(t >> 2), q = (int)(t & 3);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = shead[c]; p >= 0; p = snext[p]) {
    const float4 v = d_packed[4 * (size_t)p + q];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  d_emb[t] = acc;
}

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// The step's corner lists. head (C,) must hold -1 on entry and is left so;
// next, snext (8A,) and shead (C,) are written. n_active (1,) is read on
// the card (it may exceed A).
extern "C" int nl_pack_grad_build(const int* active_ids, const int* corner_idx,
                                  const int* n_active, int A, int C, int* head, int* next,
                                  int* shead, int* snext, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (A > 0)
    pack_grad_link_kernel<<<blocks(8LL * A), kThreads, 0, s>>>(active_ids, corner_idx,
                                                              n_active, A, C, head, next);
  if (C > 0)
    pack_grad_order_kernel<<<blocks(C), kThreads, 0, s>>>(C, head, next, shead, snext);
  return (int)cudaGetLastError();
}

// d_emb (C, 16) f32 from d_packed (A, 128) f32 over the lists of the last
// build; every row of d_emb is written.
extern "C" int nl_pack_grad(const float* d_packed, const int* shead, const int* snext, int C,
                            float* d_emb, void* stream) {
  if (C > 0)
    pack_grad_kernel<<<blocks(4LL * C), kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(d_packed), shead, snext, C,
        reinterpret_cast<float4*>(d_emb));
  return (int)cudaGetLastError();
}
