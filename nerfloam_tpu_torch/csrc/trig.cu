// trig: sin, cos and atan2 of f32 arrays rounded as XLA's CPU backend (the
// host's glibc 2.36) rounds jnp.sin, jnp.cos and jnp.arctan2, forward and
// backward, for the eager se3 and scan-to-scan ops on the card
// (ops/trig.py). No TPU kernel is behind it: the JAX package's trig ops are
// XLA elementwise ops; the kernel exists so that the card rounds a pose's
// angle as the CPU does, where CUDA's sinf / cosf / atan2f (within 2 ulp)
// and torch's do not. The arithmetic is native/trig.h, the header the host
// copies (native/trig.cpp, the plain twin) compile from.
//
// op: 0 sin(a), 1 cos(a), 2 atan2(a, b). Backward, JAX's JVP rules on the
// same functions: sin g cos(a); cos -(g sin(a)); atan2 g (b / fma(a, a, b b))
// and g (-a / fma(b, b, a a)), contracted as XLA's CPU backend does.
//
// One thread an element; each operand is read at its own element stride
// (1, or a column's). Bound on the H100: the bytes (8-12 in, 4-8 out an
// element) over 3.35 TB/s; at the port's sizes (a pose's angle, a scan's
// 100k points) a launch costs more than its bytes.

#include <cuda_runtime.h>

#include "../native/trig.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    trig_fwd_kernel(int op, const float* __restrict__ a, long sa, const float* __restrict__ b,
                    long sb, int n, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = a[i * sa];
  out[i] = op == 0 ? nl_trig::sinf(x) : op == 1 ? nl_trig::cosf(x) : nl_trig::atan2f(x, b[i * sb]);
}

__global__ void __launch_bounds__(kThreads)
    trig_bwd_kernel(int op, const float* __restrict__ a, long sa, const float* __restrict__ b,
                    long sb, const float* __restrict__ g, long sg, int n, float* __restrict__ ga,
                    float* __restrict__ gb) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = a[i * sa], gi = g[i * sg];
  if (op == 0) {
    ga[i] = __fmul_rn(gi, nl_trig::cosf(x));
  } else if (op == 1) {
    ga[i] = -__fmul_rn(gi, nl_trig::sinf(x));
  } else {
    const float y = b[i * sb];
    ga[i] = __fmul_rn(gi, __fdiv_rn(y, __fmaf_rn(x, x, __fmul_rn(y, y))));
    gb[i] = __fmul_rn(gi, __fdiv_rn(-x, __fmaf_rn(y, y, __fmul_rn(x, x))));
  }
}

}  // namespace

// a, b: the operands at element strides sa, sb (b unread unless op == 2);
// out: n f32
extern "C" int nl_trig_fwd(int op, const float* a, long sa, const float* b, long sb, int n,
                           float* out, void* stream) {
  if (n > 0) {
    trig_fwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        op, a, sa, b, sb, n, out);
  }
  return (int)cudaGetLastError();
}

// g: the output's cotangent at stride sg; ga (and gb for atan2): n f32
extern "C" int nl_trig_bwd(int op, const float* a, long sa, const float* b, long sb,
                           const float* g, long sg, int n, float* ga, float* gb, void* stream) {
  if (n > 0) {
    trig_bwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        op, a, sa, b, sb, g, sg, n, ga, gb);
  }
  return (int)cudaGetLastError();
}
