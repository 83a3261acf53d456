// K3: the GN tracker's residuals, count-balanced weights and 6x6 normal
// equations (port of nerfloam_tpu/core/tracking.py:217-244
// _residual_parts and 300-315, the two einsums).
//
// Per sample (ray n, column m of the M hits samples + K band/anchor
// columns): front = z cos < d - T, band = not front, not z cos > d + T and
// the ray's depth is ok; r = sdf - 1 (front) or z cos + (sdf - bias) T - d
// (band); J = [g s, (xyz - t) x g s] with s = 1 (front) or T (band). The
// balancing weights w_fs = fs_weight (1 - n_front / n), w_sdf = sdf_weight
// (1 - n_band / n) depend on the global counts, so one pass accumulates,
// per class, the unweighted sums J J^T (21 entries), J r (6) and r^2 (1)
// and the class count; the end combines w_fs * S_front + w_sdf * S_band.
//
// Bound on the H100: it reads 33 B per sample (xyz, z, sdf, g, mask) plus
// 13 B per ray, ~4.9 MB at 2048 x 72, and does ~100 flops per sample:
// memory-bound, ~1.5 us at 3.35 TB/s. The work is one wave's worth, so
// what holds it is latency: the sample loads, then the reduction across
// blocks. The earlier two-launch form spent ~6.5 of its ~13 us in its
// second launch, one block in which 58 threads each added every partial
// row from global memory one after another. Design:
//   - one launch of G = min(132, ceil(N MK / (512 x 2))) blocks of 512
//     threads, one an SM at the most: thread t takes samples t, t + 512 G,
//     ... and issues the loads of two of them (and of their rays' values,
//     the ray a division by the row length) before it adds either, so a
//     2048 x 72 iteration is one round of loads. Fewer, larger blocks beat
//     two blocks an SM of 256 threads, and a warp a ray, on the card: the
//     end of the kernel costs per block, not per sample;
//   - the two classes accumulate without a branch: J and r are zeroed by a
//     select outside their class, so every sample adds into both sets of
//     sums (a masked product adds +0);
//   - a warp reduces its 58 values (2 x 28 sums, 2 counts) by a
//     reduce-scatter butterfly: 31 shuffles per 32 values, after which lane
//     L holds the warp's sum of value L (not 58 five-step trees);
//   - the block's warps are added in order into one row of partial sums,
//     stored value-major (partial[v * G + block]) in a scratch the caller
//     owns. The block that takes the last ticket on a counter in that
//     scratch (an acquire-release add: a block's row is visible before
//     its ticket, and every row to the last block) adds the rows: a warp
//     per value, each lane the rows lane, lane + 32, ... (all loaded
//     before the adds), then a butterfly; 36 + 6 + 1 threads form H, b and
//     the loss in parallel, and it resets the counter, so no call needs a
//     memset.
// Sum order, for a given N x MK: a thread adds its samples in ascending
// index; the butterfly pairs lanes at distances 16, 8, 4, 2, 1; a block
// adds its warps in order; the last block adds partial rows j = lane +
// 32 k in ascending k per lane, then the lanes by a butterfly. It depends
// only on N and MK (they fix the grid), never on which block finishes
// last, so two runs give the same bits. The counts are summed as floats:
// exact below 2^24 samples, which the wrapper enforces.

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132;      // one per SM of an H100 SXM
constexpr int kCls = 28;             // 21 (J J^T upper) + 6 (J r) + 1 (r^2)
constexpr int kVals = 2 * kCls + 2;  // front sums, band sums, two counts
constexpr int kPad = 64;             // kVals rounded up to two warps' widths
constexpr int kValsPerWarp = (kVals + kWarps - 1) / kWarps;  // in the last block
constexpr int kRowsPerLane = (kMaxBlocks + 31) / 32;
constexpr int kBatch = 2;            // samples a thread loads at once

// One stage of a warp's reduce-scatter: lanes O apart swap halves of
// their 2 O values, the lane with bit O set keeping the upper half. The
// stride is a template constant so that every index into a is known at
// compile time and the array stays in registers.
template <int O>
__device__ __forceinline__ void reduce_scatter_stage(float (&a)[32], unsigned lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? a[j] : a[j + O];
    const float keep = upper ? a[j + O] : a[j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Reduce-scatter over a warp: on entry each lane holds 32 values a[0..31];
// on exit a[0] of lane L is the sum over the warp's lanes of value L.
__device__ __forceinline__ float warp_reduce_scatter(float (&a)[32], unsigned lane) {
  reduce_scatter_stage<16>(a, lane);
  reduce_scatter_stage<8>(a, lane);
  reduce_scatter_stage<4>(a, lane);
  reduce_scatter_stage<2>(a, lane);
  reduce_scatter_stage<1>(a, lane);
  return a[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 512 / kThreads) gn_system_kernel(
    const float* __restrict__ xyz, const float* __restrict__ z, const float* __restrict__ sdf,
    const float* __restrict__ g, const unsigned char* __restrict__ vmask,
    const float* __restrict__ pcos, const float* __restrict__ d_meas,
    const unsigned char* __restrict__ depth_ok, const float* __restrict__ bias_ray,
    const float* __restrict__ t_pos, int N, int MK, float T, float fs_weight, float sdf_weight,
    float* __restrict__ partial, unsigned* __restrict__ counter, float* __restrict__ H,
    float* __restrict__ b, float* __restrict__ loss) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  // values 0..27 front, 28..55 band, 56 / 57 the counts, 58..63 zero
  float v[kPad];
#pragma unroll
  for (int k = 0; k < kPad; ++k) v[k] = 0.0f;
  const float t0 = t_pos[0], t1 = t_pos[1], t2 = t_pos[2];
  const int n = N * MK, stride = G * kThreads;
  for (int i0 = blockIdx.x * kThreads + threadIdx.x; i0 < n; i0 += kBatch * stride) {
    // every load of the thread's next kBatch samples (and of their rays)
    // issued before the sums; a sample past the end reads the last one and
    // is masked
    float zs[kBatch], ss[kBatch], gs[kBatch][3], qs[kBatch][3], pcs[kBatch], ds[kBatch],
        bs[kBatch];
    bool ms[kBatch], oks[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * stride;
      const int j = i < n ? i : n - 1;
      const int ray = j / MK;
      ms[k] = i < n && vmask[j];
      zs[k] = z[j];
      ss[k] = sdf[j];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gs[k][a] = g[3 * j + a];
        qs[k][a] = xyz[3 * j + a];
      }
      pcs[k] = pcos[ray];
      ds[k] = d_meas[ray];
      bs[k] = bias_ray[ray];
      oks[k] = depth_ok[ray];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const float zc = zs[k] * pcs[k], d = ds[k];
      const bool front = ms[k] && zc < d - T;
      const bool band = ms[k] && !(zc < d - T) && !(zc > d + T) && oks[k];
      const float r = front ? ss[k] - 1.0f : (zc + (ss[k] - bs[k]) * T) - d;
      const float js = front ? 1.0f : T;
      const float gx = gs[k][0] * js, gy = gs[k][1] * js, gz = gs[k][2] * js;
      const float qx = qs[k][0] - t0, qy = qs[k][1] - t1, qz = qs[k][2] - t2;
      const float J[6] = {gx, gy, gz, qy * gz - qz * gy, qz * gx - qx * gz, qx * gy - qy * gx};
      float Jf[6], Jb[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        Jf[a] = front ? J[a] : 0.0f;
        Jb[a] = band ? J[a] : 0.0f;
      }
      const float rf = front ? r : 0.0f, rb = band ? r : 0.0f;
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = a; c < 6; ++c, ++e) {
          v[e] = __fmaf_rn(Jf[a], Jf[c], v[e]);
          v[kCls + e] = __fmaf_rn(Jb[a], Jb[c], v[kCls + e]);
        }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        v[21 + a] = __fmaf_rn(Jf[a], rf, v[21 + a]);
        v[kCls + 21 + a] = __fmaf_rn(Jb[a], rb, v[kCls + 21 + a]);
      }
      v[27] = __fmaf_rn(rf, rf, v[27]);
      v[kCls + 27] = __fmaf_rn(rb, rb, v[kCls + 27]);
      v[2 * kCls] += front ? 1.0f : 0.0f;
      v[2 * kCls + 1] += band ? 1.0f : 0.0f;
    }
  }

  // the warp's sums: lane L holds value L (first half) and 32 + L (second)
  __shared__ float warp_part[kWarps][kPad];
  __shared__ float tot[kPad];
  __shared__ bool last;
  float lo[32], hi[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    lo[k] = v[k];
    hi[k] = v[32 + k];
  }
  warp_part[warp][lane] = warp_reduce_scatter(lo, lane);
  warp_part[warp][32 + lane] = warp_reduce_scatter(hi, lane);
  __syncthreads();
  if (threadIdx.x < kVals) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    partial[threadIdx.x * G + blockIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // one acquire-release ticket: it releases the block's row (the barrier
    // above orders the row's stores before it) and, for the last block,
    // acquires every other block's
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(*counter);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)(G - 1);
  }
  __syncthreads();
  if (!last) return;

  // the last block: a warp per value, every load issued before the adds
  // (a missing row reads as +0, which leaves a sum as it is)
  float x[kValsPerWarp][kRowsPerLane];
#pragma unroll
  for (int u = 0; u < kValsPerWarp; ++u) {
    const int val = warp + u * kWarps;
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      const int j = lane + 32 * k;
      x[u][k] = 0.0f;
      if (32 * k < G && val < kVals && j < G) x[u][k] = __ldcg(partial + val * G + j);
    }
  }
#pragma unroll
  for (int u = 0; u < kValsPerWarp; ++u) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) s += x[u][k];
    s = warp_sum(s);
    const int val = warp + u * kWarps;
    if (lane == 0 && val < kVals) tot[val] = s;
  }
  __syncthreads();
  const float nf = tot[2 * kCls], ns = tot[2 * kCls + 1];
  const float all = fmaxf(nf + ns, 1.0f);
  const float w_fs = fs_weight * (1.0f - nf / all);
  const float w_sdf = sdf_weight * (1.0f - ns / all);
  const int t = threadIdx.x;
  if (t < 36) {  // H[i][j] from the upper-triangle entry (min, max)
    const int i = t / 6, j = t % 6;
    const int a = i < j ? i : j, c = i < j ? j : i;
    const int k = a * 6 - a * (a - 1) / 2 + (c - a);
    H[t] = w_fs * tot[k] + w_sdf * tot[kCls + k];
  } else if (t < 42) {
    b[t - 36] = w_fs * tot[21 + t - 36] + w_sdf * tot[kCls + 21 + t - 36];
  } else if (t == 42) {
    loss[0] = w_fs * tot[27] + w_sdf * tot[kCls + 27];
  } else if (t == 43) {
    *counter = 0u;  // every block has taken its ticket
  }
}

}  // namespace

extern "C" int nl_gn_partial_values() { return kVals; }

extern "C" int nl_gn_max_blocks() { return kMaxBlocks; }

// scratch: nl_gn_partial_values() x nl_gn_max_blocks() floats of partial
// rows, then one unsigned counter that is zero between calls
extern "C" int nl_gn_system(const float* xyz, const float* z, const float* sdf, const float* g,
                            const unsigned char* vmask, const float* pcos, const float* d_meas,
                            const unsigned char* depth_ok, const float* bias_ray,
                            const float* t_pos, int N, int MK, float T, float fs_weight,
                            float sdf_weight, float* scratch, float* H, float* b, float* loss,
                            void* stream) {
  // blocks enough for one batch of samples a thread, one an SM at the most
  const int n = N * MK;
  int nb = (n + kThreads * kBatch - 1) / (kThreads * kBatch);
  nb = nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + kVals * kMaxBlocks);
  gn_system_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      xyz, z, sdf, g, vmask, pcos, d_meas, depth_ok, bias_ray, t_pos, N, MK, T, fs_weight,
      sdf_weight, scratch, counter, H, b, loss);
  return (int)cudaGetLastError();
}
