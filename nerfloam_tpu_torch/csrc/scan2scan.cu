// K11a and K11b: the scan-to-scan term of the GN tracker (port of
// nerfloam_tpu/core/scan2scan.py:98-155 build_prev_scan and 170-211
// s2s_system).
//
// K11a build_prev_scan, once per tracked frame: one cooperative launch
// (every block resident at once, cudaLaunchCooperativeKernel), its phases
// apart by grid-wide syncs:
//   1  per point: range, azimuth, elevation, the depth gate and the
//      azimuth bin; each block's min / max elevation of its gated points,
//      on an order-preserving integer encoding of the float; the
//      per-pixel list heads to -1.
//   2  every block folds the blocks' spans itself (min and max do not
//      depend on the order, so all find the same span; block 0's first
//      thread writes it out); each gated point's pixel (the elevation bin
//      from the span), and the point pushed onto the pixel's list with
//      atomicExch.
//   3  per pixel: the list walked once into registers and put in
//      ascending point index by a fixed sorting network (at most 8
//      points; a longer list is walked once per point for the next index
//      up), the points added in that order, so the sum is the one a
//      sequential scatter-add in point order gives, on every run; the
//      mean point and its range.
//   4  per pixel: central differences (azimuth wraps, elevation edges are
//      invalid), the unit normal turned toward the sensor, validity, and
//      both moved to the world frame.
// One launch, where five grid-wide passes (init, span, link, pixel,
// normal) would each pay a launch and a tail for a few us of work.
// The rotation is the caller's (se3.pose_rotation, built once per frame
// and kept in PrevScan.R for K11b): the kernel and its twin read one R.

// K11b s2s_system, once per GN iteration, one launch of one thread block
// cluster (Hopper) of 8 blocks x 256 threads: thread g of the cluster takes
// rays g, g + 2048, ..., projects the current point into the previous
// sensor frame, reads its pixel, gates, weights (Huber), forms J = [n,
// (p_w - t) x n] and adds to its own 21 + 6 + 1 sums of H = sum w J J^T,
// b = sum w J r and the loss sum w r^2. Warp shuffles, then each block's 8
// warp rows in ascending order, then block 0 adding the 8 blocks' rows in
// ascending rank straight from their shared memory (distributed shared
// memory), give the totals: the same on every run, with no global scratch,
// no atomics and no second launch. (One block of 1024 threads took 12 us on
// one SM; the ray work is a few hundred dependent operations, so it is
// spread over 8 SMs.) The caller's H, b and
// loss (the SDF term's, from K3) are added in place, so the tracker issues
// no adds of its own. Both rotations come from the caller (the previous
// pose's once per frame in PrevScan, the current one from the tracker's
// rotation of the ray directions): the kernel and its twin read one R, and
// an ulp of difference in R would move a point near a bin edge to another
// pixel.
//
// Every arithmetic step is one IEEE-rounded operation in JAX's order (no
// FMA but in the lengths: the range, the horizontal range, a pixel's depth
// and its normal's length are jnp.linalg.norm's fused chains, ieee.cuh), so
// bins and pixels agree with the plain torch versions.
//
// Bound on the H100: K11a moves 13 B per point in and 41 B per pixel out
// (2.7 MB at 65,536 points and 64 x 1024 pixels, under 1 us at 3.35 TB/s);
// K11b reads 13 B per ray and 29 B per associated pixel (86 KB at 2048
// rays). Both are bound by their launches, not by bytes or operations.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ieee.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxList = 8;          // K11a: points a pixel sorted in registers
constexpr int kRangeMaxBlocks = 1024;  // K11a: blocks of its cooperative launch at most
constexpr int kMaxDevices = 64;
constexpr int kS2SBlocks = 8;      // K11b: one cluster of 8 blocks (the portable most)
constexpr int kS2SThreads = 256;   // ... of 256 threads
constexpr int kSums = 28;  // 21 (H upper) + 6 (b) + 1 (loss)
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// monotone float -> int map, so integer atomicMin / atomicMax order floats
__device__ __forceinline__ int enc(float f) {
  int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// (azimuth, elevation, range) of a sensor-frame point
__device__ __forceinline__ void angles(float x, float y, float z, float& az, float& elev,
                                       float& d) {
  d = ieee_norm3(x, y, z);
  az = atan2f(y, x);
  elev = atan2f(z, __fadd_rn(ieee_norm2(x, y), 1e-12f));
}

__device__ __forceinline__ int clip_bin(float v, int n) {
  int i = (int)v;  // truncates, saturates
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ float elev_bin_f(float elev, float e_min, float e_max, int B) {
  float span = fmaxf(__fsub_rn(e_max, e_min), 1e-3f);
  return __fmul_rn(__fdiv_rn(__fsub_rn(elev, e_min), span), (float)(B - 1));
}

__device__ __forceinline__ int az_bin(float az, int A) {
  return clip_bin(__fmul_rn(__fdiv_rn(__fadd_rn(az, kPi), kTwoPi), (float)A), A);
}

// out = R v (+ t): rows of R times v, summed left to right
__device__ __forceinline__ void rotate(const float* __restrict__ R, const float (&v)[3],
                                       float (&out)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = dot3(v[0], v[1], v[2], R[3 * r], R[3 * r + 1], R[3 * r + 2]);
}

__device__ __forceinline__ void order(int& x, int& y) {
  const int lo = min(x, y), hi = max(x, y);
  x = lo;
  y = hi;
}

// the block's min of lo and max of hi, in every thread
__device__ __forceinline__ void block_span(int& lo, int& hi, int* s_lo, int* s_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
  __syncthreads();
}

// the sum of a pixel's points in ascending point index, and their count:
// its list (head, next) walked once into registers and put in order by a
// fixed sorting network when it holds at most kMaxList points, else walked
// once per point for the smallest index above the last one added
__device__ __forceinline__ int pixel_sum(int head, const int* __restrict__ next,
                                         const float* __restrict__ points, float (&s)[3]) {
  int e[kMaxList];
  int p = head, k = 0;
#pragma unroll
  for (int j = 0; j < kMaxList; ++j) {
    e[j] = p >= 0 ? p : INT_MAX;  // absent entries sort last
    if (p >= 0) {
      ++k;
      p = next[p];
    }
  }
  s[0] = s[1] = s[2] = 0.0f;
  if (p < 0) {
    order(e[0], e[2]), order(e[1], e[3]), order(e[4], e[6]), order(e[5], e[7]);
    order(e[0], e[4]), order(e[1], e[5]), order(e[2], e[6]), order(e[3], e[7]);
    order(e[0], e[1]), order(e[2], e[3]), order(e[4], e[5]), order(e[6], e[7]);
    order(e[2], e[4]), order(e[3], e[5]);
    order(e[1], e[4]), order(e[3], e[6]);
    order(e[1], e[2]), order(e[3], e[4]), order(e[5], e[6]);
#pragma unroll
    for (int j = 0; j < kMaxList; ++j) {
      if (j >= k) continue;
#pragma unroll
      for (int d = 0; d < 3; ++d) s[d] = __fadd_rn(s[d], points[3 * e[j] + d]);
    }
    return k;
  }
  for (; p >= 0; p = next[p]) ++k;
  int last = -1;
  for (int n = 0; n < k; ++n) {
    int cur = INT_MAX;
    for (int q = head; q >= 0; q = next[q])
      if (q > last && q < cur) cur = q;
    last = cur;
#pragma unroll
    for (int d = 0; d < 3; ++d) s[d] = __fadd_rn(s[d], points[3 * cur + d]);
  }
  return k;
}

// K11a, one cooperative launch (every block resident), four phases apart
// by grid-wide syncs (see the header).
__global__ void __launch_bounds__(kThreads) s2s_range_image_kernel(
    const float* __restrict__ points, const unsigned char* __restrict__ valid, int P, int B,
    int A, float min_depth, float max_depth, const float* __restrict__ R,
    const float* __restrict__ t, float* __restrict__ elev, int* __restrict__ abin,
    int* __restrict__ next, int* __restrict__ head, int* __restrict__ part,
    float* __restrict__ p_img, unsigned char* __restrict__ has_pt, float* __restrict__ q_w,
    float* __restrict__ n_w, unsigned char* __restrict__ pix_valid, float* __restrict__ depth,
    float* __restrict__ span_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];
  const int total = B * A;
  const int g = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;
  // 1: the list heads to -1; each point's angles, depth gate and azimuth
  // bin; each block's elevation span of its gated points
  for (int i = g; i < total; i += stride) head[i] = -1;
  int lo = enc(1e9f), hi = enc(-1e9f);
  for (int i = g; i < P; i += stride) {
    float az, el, d;
    angles(points[3 * i], points[3 * i + 1], points[3 * i + 2], az, el, d);
    const bool ok = valid[i] && d > min_depth && d < max_depth;
    elev[i] = el;
    abin[i] = ok ? az_bin(az, A) : -1;
    if (ok) {
      lo = min(lo, enc(el));
      hi = max(hi, enc(el));
    }
  }
  block_span(lo, hi, s_lo, s_hi);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = lo;
    part[2 * blockIdx.x + 1] = hi;
  }
  grid.sync();
  // 2: every block folds the blocks' spans (min and max: the same span in
  // each, whatever the order); each gated point joins its pixel's list
  lo = enc(1e9f), hi = enc(-1e9f);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    lo = min(lo, part[2 * b]);
    hi = max(hi, part[2 * b + 1]);
  }
  block_span(lo, hi, s_lo, s_hi);
  const float e_min = dec(lo), e_max = dec(hi);
  if (g == 0) {
    span_out[0] = e_min;
    span_out[1] = e_max;
  }
  for (int i = g; i < P; i += stride) {
    const int ab = abin[i];
    if (ab < 0) continue;
    const int bi = clip_bin(elev_bin_f(elev[i], e_min, e_max, B), B);
    next[i] = atomicExch(head + bi * A + ab, i);
  }
  grid.sync();
  // 3: each pixel's mean point, its points added in ascending index
  for (int pix = g; pix < total; pix += stride) {
    float sum[3];
    const int k = pixel_sum(head[pix], next, points, sum);
    const float c = fmaxf((float)k, 1.0f);
    const float x = __fdiv_rn(sum[0], c), y = __fdiv_rn(sum[1], c), z = __fdiv_rn(sum[2], c);
    p_img[3 * pix] = x;
    p_img[3 * pix + 1] = y;
    p_img[3 * pix + 2] = z;
    has_pt[pix] = k > 0;
    depth[pix] = ieee_norm3(x, y, z);
  }
  grid.sync();
  // 4: central-difference normals (azimuth wraps, the elevation edges are
  // invalid), turned toward the sensor, and both moved to the world frame
  for (int pix = g; pix < total; pix += stride) {
    const int b = pix / A, a = pix - b * A;
    const int a1 = b * A + (a + 1 == A ? 0 : a + 1), a0 = b * A + (a == 0 ? A - 1 : a - 1);
    const int e1 = (b + 1 < B ? b + 1 : B - 1) * A + a, e0 = (b > 0 ? b - 1 : 0) * A + a;
    const bool ve1 = b + 1 < B && has_pt[e1], ve0 = b > 0 && has_pt[e0];
    float u[3], w[3], p[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      u[d] = __fsub_rn(p_img[3 * a1 + d], p_img[3 * a0 + d]);
      w[d] = __fsub_rn(p_img[3 * e1 + d], p_img[3 * e0 + d]);
      p[d] = p_img[3 * pix + d];
    }
    float n[3] = {__fsub_rn(__fmul_rn(u[1], w[2]), __fmul_rn(u[2], w[1])),
                  __fsub_rn(__fmul_rn(u[2], w[0]), __fmul_rn(u[0], w[2])),
                  __fsub_rn(__fmul_rn(u[0], w[1]), __fmul_rn(u[1], w[0]))};
    const float nn = ieee_norm3(n[0], n[1], n[2]);
    const float den = fmaxf(nn, 1e-9f);
#pragma unroll
    for (int d = 0; d < 3; ++d) n[d] = __fdiv_rn(n[d], den);
    if (dot3(n[0], n[1], n[2], p[0], p[1], p[2]) > 0.0f) {
#pragma unroll
      for (int d = 0; d < 3; ++d) n[d] = -n[d];
    }
    pix_valid[pix] = has_pt[pix] && has_pt[a1] && has_pt[a0] && ve1 && ve0 && nn > 1e-6f;
    float q[3], nw[3];
    rotate(R, p, q);
    rotate(R, n, nw);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      q_w[3 * pix + d] = __fadd_rn(q[d], t[d]);
      n_w[3 * pix + d] = nw[d];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// K11b, launched as one cluster (see the header); with accumulate set each
// output becomes out + ours, one rounded add per entry.
__global__ void __cluster_dims__(kS2SBlocks, 1, 1) __launch_bounds__(kS2SThreads)
    s2s_system_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ rvalid,
                      int N, const float* __restrict__ Rc, const float* __restrict__ tc,
                      const float* __restrict__ Rp, const float* __restrict__ tp,
                      const float* __restrict__ q_w, const float* __restrict__ n_w,
                      const unsigned char* __restrict__ pix_valid,
                      const float* __restrict__ depth, const float* __restrict__ e_min_p,
                      const float* __restrict__ e_max_p, int B, int A, float min_depth,
                      float max_depth, float gate, float gate2, float huber, float weight,
                      int accumulate, float* __restrict__ H, float* __restrict__ b,
                      float* __restrict__ loss) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  const float e_min = e_min_p[0], e_max = e_max_p[0];
  for (int i = rank * kS2SThreads + threadIdx.x; i < N; i += kS2SBlocks * kS2SThreads) {
    float p[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]}, pw[3], dp[3];
    rotate(Rc, p, pw);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      pw[d] = __fadd_rn(pw[d], tc[d]);
      dp[d] = __fsub_rn(pw[d], tp[d]);
    }
    // R_prev^T (p_w - t_prev): columns of R_prev
    float pp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) pp[c] = dot3(dp[0], dp[1], dp[2], Rp[c], Rp[3 + c], Rp[6 + c]);
    float az, elev, d;
    angles(pp[0], pp[1], pp[2], az, elev, d);
    float bi_f = elev_bin_f(elev, e_min, e_max, B);
    bool in_img = bi_f >= -0.5f && bi_f <= (float)B - 0.5f && d > min_depth && d < max_depth;
    int pix = clip_bin(bi_f, B) * A + az_bin(az, A);
    float n[3] = {n_w[3 * pix], n_w[3 * pix + 1], n_w[3 * pix + 2]};
    float r = dot3(n[0], n[1], n[2], __fsub_rn(pw[0], q_w[3 * pix]),
                   __fsub_rn(pw[1], q_w[3 * pix + 1]), __fsub_rn(pw[2], q_w[3 * pix + 2]));
    float absr = fabsf(r);
    bool m = rvalid[i] && in_img && pix_valid[pix] && absr < gate &&
             fabsf(__fsub_rn(d, depth[pix])) < gate2;
    if (!m) continue;
    float w = absr <= huber ? 1.0f : __fdiv_rn(huber, fmaxf(absr, 1e-9f));
    w = __fmul_rn(w, weight);
    float qx = __fsub_rn(pw[0], tc[0]), qy = __fsub_rn(pw[1], tc[1]), qz = __fsub_rn(pw[2], tc[2]);
    float J[6] = {n[0], n[1], n[2], qy * n[2] - qz * n[1], qz * n[0] - qx * n[2],
                  qx * n[1] - qy * n[0]};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float jw = J[a] * w;
#pragma unroll
      for (int c = a; c < 6; ++c) acc[k++] += jw * J[c];
      acc[21 + a] += jw * r;
    }
    acc[27] += w * r * r;
  }
  // lanes by shuffles, then the block's warps in ascending order
  __shared__ float warp_part[kS2SThreads / 32][kSums];
  __shared__ float block_tot[kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = warp_sum(acc[k]);
    if (lane == 0) warp_part[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.0f;
    for (int wp = 0; wp < kS2SThreads / 32; ++wp) s += warp_part[wp][threadIdx.x];
    block_tot[threadIdx.x] = s;
  }
  cluster.sync();  // every block's row is in its shared memory
  // block 0 adds the blocks' rows in ascending rank, read from their shared
  // memory (no global scratch, no atomics); 43 outputs, one thread each:
  // H (row-major, both triangles from the 21 upper sums), b, loss
  const int o = threadIdx.x;
  if (rank == 0 && o < 43) {
    int u = o < 36 ? 0 : (o < 42 ? 21 + (o - 36) : 27);
    if (o < 36) {
      int i = o / 6, j = o - 6 * (o / 6);
      int lo = min(i, j), hi = max(i, j);
      u = 6 * lo - lo * (lo - 1) / 2 + (hi - lo);
    }
    float v = 0.0f;
    for (int r = 0; r < kS2SBlocks; ++r) v += cluster.map_shared_rank(block_tot, r)[u];
    float* out = o < 36 ? H + o : (o < 42 ? b + (o - 36) : loss);
    *out = accumulate ? __fadd_rn(*out, v) : v;
  }
  cluster.sync();  // the other blocks keep their shared memory until block 0 has read it
}

}  // namespace

// K11a's scratch, in this order: elev (P floats), abin and next (P ints
// each), head (n_elev * n_az ints), the blocks' spans
// (nl_range_image_part_ints), p_img (3 floats a pixel), has_pt (a byte a
// pixel). R (9) and t (3) are the previous pose's.
extern "C" int nl_range_image_part_ints() { return 2 * kRangeMaxBlocks; }

extern "C" int nl_build_prev_scan(const float* points, const unsigned char* valid, int P,
                                  const float* R, const float* t, int n_elev, int n_az,
                                  float min_depth, float max_depth, float* elev, int* abin,
                                  int* next, int* head, int* part, float* p_img,
                                  unsigned char* has_pt, float* q_w, float* n_w,
                                  unsigned char* pix_valid, float* depth, float* span_out,
                                  void* stream) {
  static int resident[kMaxDevices];  // blocks that fit the card at once, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2s_range_image_kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm == 0) return (int)cudaErrorLaunchOutOfResources;
    resident[dev] = min(sms * per_sm, kRangeMaxBlocks);
  }
  const int total = n_elev * n_az;
  const int blocks = max(1, min(resident[dev], (max(P, total) + kThreads - 1) / kThreads));
  void* args[] = {&points, &valid, &P, &n_elev, &n_az, &min_depth, &max_depth, &R, &t,
                  &elev, &abin, &next, &head, &part, &p_img, &has_pt, &q_w, &n_w,
                  &pix_valid, &depth, &span_out};
  err = cudaLaunchCooperativeKernel((const void*)s2s_range_image_kernel, blocks, kThreads, args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// H (6 x 6), b (6) and loss (1) are written; with accumulate != 0 they hold
// the caller's sums on entry and ours are added to them in place.
extern "C" int nl_s2s_system(const float* pts, const unsigned char* rvalid, int N,
                             const float* Rc, const float* tc, const float* Rp, const float* tp,
                             const float* q_w, const float* n_w, const unsigned char* pix_valid,
                             const float* depth, const float* e_min, const float* e_max,
                             int n_elev, int n_az, float min_depth, float max_depth, float gate,
                             float gate2, float huber, float weight, int accumulate, float* H,
                             float* b, float* loss, void* stream) {
  s2s_system_kernel<<<kS2SBlocks, kS2SThreads, 0, (cudaStream_t)stream>>>(
      pts, rvalid, N, Rc, tc, Rp, tp, q_w, n_w, pix_valid, depth, e_min, e_max, n_elev, n_az,
      min_depth, max_depth, gate, gate2, huber, weight, accumulate, H, b, loss);
  return (int)cudaGetLastError();
}
