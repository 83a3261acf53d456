// K11a and K11b: the scan-to-scan term of the GN tracker (port of
// nerfloam_tpu/core/scan2scan.py:98-155 build_prev_scan and 170-211
// s2s_system).
//
// K11a build_prev_scan, once per tracked frame, five passes in one call:
//   init    per-pixel list heads to -1, the elevation span to (+1e9, -1e9).
//   span    one thread per point: range, azimuth, elevation, the depth
//           gate; min / max elevation of the gated points by integer
//           atomics on an order-preserving encoding of the float (min and
//           max do not depend on the order).
//   link    one thread per gated point: its pixel (elevation bin from the
//           span, azimuth bin), pushed onto the pixel's list with
//           atomicExch.
//   pixel   one thread per pixel: counts its list, then adds the points in
//           ascending point index, so the per-pixel sum is the one a
//           sequential scatter-add in point order gives, on every run; the
//           mean point and its range.
//   normal  one thread per pixel: central differences (azimuth wraps,
//           elevation edges are invalid), the unit normal turned toward
//           the sensor, validity, and both moved to the world frame.
// The list order from atomicExch varies from run to run; the walk in
// ascending index does not (the remedy of csrc/reconcile.cu). The walk
// costs k^2 steps for a pixel with k points; a scan spreads its points
// over the image, k is a handful.
//
// K11b s2s_system, once per GN iteration: one thread per ray projects the
// current point into the previous sensor frame, reads its pixel, gates,
// weights (Huber) and forms J = [n, (p_w - t) x n]; the 21 + 6 + 1 sums of
// H = sum w J J^T, b = sum w J r and the loss sum w r^2 go through a
// deterministic two-stage reduction (per-block rows, then one block adds
// the rows in order), as in csrc/gn_system.cu.
//
// Every arithmetic step is one IEEE-rounded operation in JAX's order (no
// FMA), so bins and pixels agree with the plain torch versions.
//
// Bound on the H100: K11a moves 13 B per point in and 41 B per pixel out
// (2.7 MB at 65,536 points and 64 x 1024 pixels, under 1 us at 3.35 TB/s);
// K11b reads 13 B per ray and 29 B per associated pixel (86 KB at 2048
// rays). Both are bound by their launches, not by bytes or operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;
constexpr int kSums = 28;  // 21 (H upper) + 6 (b) + 1 (loss)
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// monotone float -> int map, so integer atomicMin / atomicMax order floats
__device__ __forceinline__ int enc(float f) {
  int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// (azimuth, elevation, range) of a sensor-frame point
__device__ __forceinline__ void angles(float x, float y, float z, float& az, float& elev,
                                       float& d) {
  d = norm3(x, y, z);
  az = atan2f(y, x);
  float horiz = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  elev = atan2f(z, __fadd_rn(horiz, 1e-12f));
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

__global__ void s2s_init_kernel(int total, int* __restrict__ head, int* __restrict__ span_key) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) head[i] = -1;
  if (i == 0) {
    span_key[0] = enc(1e9f);
    span_key[1] = enc(-1e9f);
  }
}

__global__ void s2s_span_kernel(const float* __restrict__ points,
                                const unsigned char* __restrict__ valid, int P, float min_depth,
                                float max_depth, float* __restrict__ az_out,
                                float* __restrict__ elev_out, unsigned char* __restrict__ ok_out,
                                int* __restrict__ span_key) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int lo = enc(1e9f), hi = enc(-1e9f);
  if (i < P) {
    float az, elev, d;
    angles(points[3 * i], points[3 * i + 1], points[3 * i + 2], az, elev, d);
    bool ok = valid[i] && d > min_depth && d < max_depth;
    az_out[i] = az;
    elev_out[i] = elev;
    ok_out[i] = ok;
    if (ok) lo = hi = enc(elev);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(span_key, lo);
    atomicMax(span_key + 1, hi);
  }
}

__global__ void s2s_link_kernel(const float* __restrict__ az, const float* __restrict__ elev,
                                const unsigned char* __restrict__ ok, int P, int B, int A,
                                const int* __restrict__ span_key, int* __restrict__ next,
                                int* __restrict__ head) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P || !ok[i]) return;
  int bi = clip_bin(elev_bin_f(elev[i], dec(span_key[0]), dec(span_key[1]), B), B);
  next[i] = atomicExch(head + bi * A + az_bin(az[i], A), i);
}

__global__ void s2s_pixel_kernel(const float* __restrict__ points, const int* __restrict__ next,
                                 const int* __restrict__ head, int total,
                                 float* __restrict__ p_img, unsigned char* __restrict__ has_pt,
                                 float* __restrict__ depth) {
  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= total) return;
  int h = head[pix];
  int k = 0;
  for (int p = h; p >= 0; p = next[p]) ++k;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  int last = -1;
  for (int n = 0; n < k; ++n) {
    int cur = 0x7fffffff;  // the smallest entry above the last one added
    for (int p = h; p >= 0; p = next[p])
      if (p > last && p < cur) cur = p;
    last = cur;
    sx = __fadd_rn(sx, points[3 * cur]);
    sy = __fadd_rn(sy, points[3 * cur + 1]);
    sz = __fadd_rn(sz, points[3 * cur + 2]);
  }
  float c = fmaxf((float)k, 1.0f);
  float x = __fdiv_rn(sx, c), y = __fdiv_rn(sy, c), z = __fdiv_rn(sz, c);
  p_img[3 * pix] = x;
  p_img[3 * pix + 1] = y;
  p_img[3 * pix + 2] = z;
  has_pt[pix] = k > 0;
  depth[pix] = norm3(x, y, z);
}

// out = R v (+ t): rows of R times v, summed left to right
__device__ __forceinline__ void rotate(const float* __restrict__ R, const float (&v)[3],
                                       float (&out)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = dot3(v[0], v[1], v[2], R[3 * r], R[3 * r + 1], R[3 * r + 2]);
}

__global__ void s2s_normal_kernel(const float* __restrict__ p_img,
                                  const unsigned char* __restrict__ has_pt, int B, int A,
                                  const float* __restrict__ R, const float* __restrict__ t,
                                  const int* __restrict__ span_key, float* __restrict__ q_w,
                                  float* __restrict__ n_w, unsigned char* __restrict__ pix_valid,
                                  float* __restrict__ span_out) {
  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix == 0) {
    span_out[0] = dec(span_key[0]);
    span_out[1] = dec(span_key[1]);
  }
  if (pix >= B * A) return;
  int b = pix / A, a = pix - b * A;
  int a1 = b * A + (a + 1 == A ? 0 : a + 1), a0 = b * A + (a == 0 ? A - 1 : a - 1);
  int e1 = (b + 1 < B ? b + 1 : B - 1) * A + a, e0 = (b > 0 ? b - 1 : 0) * A + a;
  bool ve1 = b + 1 < B && has_pt[e1], ve0 = b > 0 && has_pt[e0];
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
  float nn = norm3(n[0], n[1], n[2]);
  float den = fmaxf(nn, 1e-9f);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void s2s_partial_kernel(const float* __restrict__ pts,
                                   const unsigned char* __restrict__ rvalid, int N,
                                   const float* __restrict__ Rc, const float* __restrict__ tc,
                                   const float* __restrict__ Rp, const float* __restrict__ tp,
                                   const float* __restrict__ q_w, const float* __restrict__ n_w,
                                   const unsigned char* __restrict__ pix_valid,
                                   const float* __restrict__ depth,
                                   const float* __restrict__ e_min_p,
                                   const float* __restrict__ e_max_p, int B, int A,
                                   float min_depth, float max_depth, float gate, float gate2,
                                   float huber, float weight, float* __restrict__ partial) {
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  const float e_min = e_min_p[0], e_max = e_max_p[0];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N; i += gridDim.x * kThreads) {
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
  __shared__ float warp_part[kThreads / 32][kSums];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = warp_sum(acc[k]);
    if (lane == 0) warp_part[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.0f;
    for (int wp = 0; wp < kThreads / 32; ++wp) s += warp_part[wp][threadIdx.x];
    partial[blockIdx.x * kSums + threadIdx.x] = s;
  }
}

__global__ void s2s_final_kernel(const float* __restrict__ partial, int n_blocks,
                                 float* __restrict__ H, float* __restrict__ b,
                                 float* __restrict__ loss) {
  __shared__ float tot[kSums];
  if (threadIdx.x < kSums) {
    float s = 0.0f;
    for (int k = 0; k < n_blocks; ++k) s += partial[k * kSums + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j, ++k) {
      H[6 * i + j] = tot[k];
      H[6 * j + i] = tot[k];
    }
  for (int i = 0; i < 6; ++i) b[i] = tot[21 + i];
  loss[0] = tot[27];
}

}  // namespace

// Scratch: az, elev (P floats each), ok (P bytes), next (P ints), head
// (n_elev * n_az ints), span_key (2 ints), p_img (3 floats per pixel),
// has_pt (1 byte per pixel). R (9) and t (3) are the previous pose.
extern "C" int nl_build_prev_scan(const float* points, const unsigned char* valid, int P,
                                  const float* R, const float* t, int n_elev, int n_az,
                                  float min_depth, float max_depth, float* az, float* elev,
                                  unsigned char* ok, int* next, int* head, int* span_key,
                                  float* p_img, unsigned char* has_pt, float* q_w, float* n_w,
                                  unsigned char* pix_valid, float* depth, float* span_out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int total = n_elev * n_az;
  s2s_init_kernel<<<blocks(total), kThreads, 0, s>>>(total, head, span_key);
  if (P > 0) {
    s2s_span_kernel<<<blocks(P), kThreads, 0, s>>>(points, valid, P, min_depth, max_depth, az,
                                                    elev, ok, span_key);
    s2s_link_kernel<<<blocks(P), kThreads, 0, s>>>(az, elev, ok, P, n_elev, n_az, span_key, next,
                                                    head);
  }
  s2s_pixel_kernel<<<blocks(total), kThreads, 0, s>>>(points, next, head, total, p_img, has_pt,
                                                       depth);
  s2s_normal_kernel<<<blocks(total), kThreads, 0, s>>>(p_img, has_pt, n_elev, n_az, R, t,
                                                        span_key, q_w, n_w, pix_valid, span_out);
  return (int)cudaGetLastError();
}

extern "C" int nl_s2s_partial_values() { return kSums; }

extern "C" int nl_s2s_blocks(int n) {
  int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// partial: nl_s2s_blocks(N) x nl_s2s_partial_values() floats of scratch
extern "C" int nl_s2s_system(const float* pts, const unsigned char* rvalid, int N,
                             const float* Rc, const float* tc, const float* Rp, const float* tp,
                             const float* q_w, const float* n_w, const unsigned char* pix_valid,
                             const float* depth, const float* e_min, const float* e_max,
                             int n_elev, int n_az, float min_depth, float max_depth, float gate,
                             float gate2, float huber, float weight, float* partial, float* H,
                             float* b, float* loss, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int nb = nl_s2s_blocks(N);
  s2s_partial_kernel<<<nb, kThreads, 0, s>>>(pts, rvalid, N, Rc, tc, Rp, tp, q_w, n_w, pix_valid,
                                             depth, e_min, e_max, n_elev, n_az, min_depth,
                                             max_depth, gate, gate2, huber, weight, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  s2s_final_kernel<<<1, 32, 0, s>>>(partial, nb, H, b, loss);
  return (int)cudaGetLastError();
}
