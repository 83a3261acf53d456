// K5: fold one BA step's packed-copy deltas back into the canonical
// embeddings (port of nerfloam_tpu/map/voxel_map.py:233-287
// reconcile_packed in "mean" mode and 290-298 bump_upd_count; the repack,
// 301-308 pack_embeddings, is the pack pass of csrc/active_set.cu), as the
// tail of core/ba.py:378-391 calls them.
//
// Three passes; the wrapper (map/voxel_map.py reconcile) runs the inclusive
// prefix sum of the touched mask with torch.cumsum before the first:
//   compact   one thread per active row a: a touched row bumps
//             upd_count[active_ids[a]] and, when its rank r < T
//             (touched_cap), takes slot r of the compacted list t_rows. The
//             same launch resets the per-corner list heads (grid-stride).
//   link      one thread per contribution i = 8 r + k (compacted row r,
//             corner slot k): c = corner_idx[active_ids[t_rows[r]]][k], and
//             i is pushed onto corner c's list with atomicExch on head[c].
//   apply     one thread per (contribution, feature); only the thread of the
//             contribution that ended at the head of its corner's list goes
//             on. It counts the list (the corner's multiplicity k), then
//             walks it in ascending i, i.e. ascending (rank, corner slot),
//             and adds each delta (new - old) / k, cast to the embedding
//             type BEFORE the add as JAX does, rounding after every add.
// The list order from atomicExch varies from run to run; the walk in
// ascending i does not, so two calls give bit-identical tables, and they
// equal a sequential index_add_ in index order (the plain twin on the CPU).
//
// Bound on the H100: at the bench shapes T = 20,480-32,768 touched rows of
// A = 73,728-131,072: the two (T, 128) f32 delta rows per touched voxel
// (old and new packed), the corner_idx rows, 8 x 16 embedding reads and
// writes per touched voxel, and a (C,) int32 head reset (8 MB at C =
// 2,097,152). Memory-bound; the walk re-reads at most 8 list entries per
// corner from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kF = 16;
constexpr int kRow = 8 * kF;

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ int n_kept(const int* rank, int A, int T) {
  int n = A > 0 ? rank[A - 1] : 0;
  return n < T ? n : T;
}

__global__ void reconcile_compact_kernel(const unsigned char* __restrict__ touched,
                                         const int* __restrict__ rank,
                                         const int* __restrict__ active_ids, int A, int T,
                                         long long C, int* __restrict__ upd_count,
                                         int* __restrict__ t_rows, int* __restrict__ head) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < C) head[t] = -1;
  if (t < A && touched[t]) {
    int a = (int)t;
    atomicAdd(upd_count + active_ids[a], 1);
    int r = rank[a] - 1;
    if (r < T) t_rows[r] = a;
  }
}

__global__ void reconcile_link_kernel(const int* __restrict__ rank, const int* __restrict__ t_rows,
                                      const int* __restrict__ active_ids,
                                      const int* __restrict__ corner_idx, int A, int T, int C,
                                      int* __restrict__ cid, int* __restrict__ next,
                                      int* __restrict__ head) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 8 * T) return;
  int r = i >> 3, k = i & 7;
  int c = -1;
  if (r < n_kept(rank, A, T)) c = corner_idx[8 * active_ids[t_rows[r]] + k];
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

template <typename Emb>
__global__ void reconcile_apply_kernel(const int* __restrict__ t_rows, const int* __restrict__ cid,
                                       const int* __restrict__ next, const int* __restrict__ head,
                                       int T, const float* __restrict__ new_packed,
                                       const float* __restrict__ old_packed,
                                       Emb* __restrict__ emb) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)8 * T * kF) return;
  int i = (int)(t / kF), f = (int)(t - (long long)i * kF);
  int c = cid[i];
  if (c < 0 || head[c] != i) return;
  int k = 0;
  for (int p = i; p >= 0; p = next[p]) ++k;
  const float kf = (float)k;
  float acc = to_f<Emb>(emb[(size_t)c * kF + f]);
  int last = -1;
  for (int n = 0; n < k; ++n) {
    int cur = 0x7fffffff;  // the smallest entry above the last one applied
    for (int p = i; p >= 0; p = next[p])
      if (p > last && p < cur) cur = p;
    last = cur;
    size_t off = (size_t)t_rows[cur >> 3] * kRow + (cur & 7) * kF + f;
    float d = __fdiv_rn(__fsub_rn(new_packed[off], old_packed[off]), kf);
    acc = to_f<Emb>(from_f<Emb>(__fadd_rn(acc, to_f<Emb>(from_f<Emb>(d)))));
  }
  emb[(size_t)c * kF + f] = from_f<Emb>(acc);
}

}  // namespace

// upd_count and emb are updated in place: the wrapper hands in fresh copies
extern "C" int nl_reconcile_compact(const unsigned char* touched, const int* rank,
                                    const int* active_ids, int A, int T, int C, int* upd_count,
                                    int* t_rows, int* head, void* stream) {
  long long n = (long long)(A > C ? A : C);
  if (n > 0)
    reconcile_compact_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        touched, rank, active_ids, A, T, C, upd_count, t_rows, head);
  return (int)cudaGetLastError();
}

extern "C" int nl_reconcile_link(const int* rank, const int* t_rows, const int* active_ids,
                                 const int* corner_idx, int A, int T, int C, int* cid, int* next,
                                 int* head, void* stream) {
  if (T > 0)
    reconcile_link_kernel<<<blocks(8LL * T), kThreads, 0, (cudaStream_t)stream>>>(
        rank, t_rows, active_ids, corner_idx, A, T, C, cid, next, head);
  return (int)cudaGetLastError();
}

extern "C" int nl_reconcile_apply(const int* t_rows, const int* cid, const int* next,
                                  const int* head, int T, const float* new_packed,
                                  const float* old_packed, void* emb, int bf16, void* stream) {
  long long n = 8LL * T * kF;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (bf16)
      reconcile_apply_kernel<__nv_bfloat16><<<blocks(n), kThreads, 0, s>>>(
          t_rows, cid, next, head, T, new_packed, old_packed,
          static_cast<__nv_bfloat16*>(emb));
    else
      reconcile_apply_kernel<float><<<blocks(n), kThreads, 0, s>>>(
          t_rows, cid, next, head, T, new_packed, old_packed, static_cast<float*>(emb));
  }
  return (int)cudaGetLastError();
}
