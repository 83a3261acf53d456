// sinf, cosf and atan2f as glibc 2.36 computes them on x86-64 with FMA,
// which is what XLA's CPU backend calls for jnp.sin, jnp.cos and
// jnp.arctan2: written once for g++ (the port's host library,
// native/trig.cpp) and nvcc (the kernels that include it from csrc/), so
// that both devices round every angle of the port as the JAX package does
// on the CPU. Each function is bit-equal to that libm on every float of
// [0, pi] (scripts/trig_every_float.py) and on seeded atan2 pairs.
//
// sinf / cosf: the ARM optimized-routines algorithm that glibc has used
// since 2.28 (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h,
// sincosf_data.c): double-precision polynomials over __sincosf_table, a
// fast reduction below 120 and a 4/pi-table reduction above.
//   Copyright (c) 2018 Arm Ltd. SPDX-License-Identifier: MIT
//   (Permission is hereby granted, free of charge, to any person obtaining
//   a copy of this software ... THE SOFTWARE IS PROVIDED "AS IS", WITHOUT
//   WARRANTY OF ANY KIND.)
// glibc's x86-64 build dispatches them to a variant compiled with -mfma,
// in which GCC contracts each a + b * c of the source into one fused
// multiply-add; the copy writes those contractions as NL_FMA and no other.
// 0x1.921FB6p-1f below is pi/4 as a float, the bound's top 12 bits.
//
// atan2f: fdlibm's e_atan2f.c and s_atanf.c as glibc carries them
// (sysdeps/ieee754/flt-32), compiled without FMA.
//   Conversion to float by Ian Lance Taylor, Cygnus Support.
//   Copyright (C) 1993 by Sun Microsystems, Inc. All rights reserved.
//   Developed at SunPro, a Sun Microsystems, Inc. business.
//   Permission to use, copy, modify, and distribute this software is
//   freely granted, provided that this notice is preserved.
//
// Build it without fast-math and with no contraction of its own (g++:
// -ffp-contract=off, which C++ modes do not imply; nvcc: -fmad=false): no
// product is fused except where NL_FMA is written.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define NL_TRIG_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define NL_TRIG_FN static inline
#endif

namespace nl_trig {

#ifdef __CUDACC__
#ifdef __CUDA_ARCH__
#define NL_FMA(a, b, c) __fma_rn((a), (b), (c))
#else
#define NL_FMA(a, b, c) ::fma((a), (b), (c))
#endif
#else
#define NL_FMA(a, b, c) std::fma((a), (b), (c))
#endif

NL_TRIG_FN uint32_t asuint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

NL_TRIG_FN float asfloat(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// Top 12 bits of the float representation with the sign bit cleared.
NL_TRIG_FN uint32_t abstop12(float x) { return (asuint(x) >> 20) & 0x7ff; }

// __sincosf_table[0] (the second entry negates the cosine polynomial).
// hpi_inv is 2/pi scaled by 2^24: x86-64 has no TOINT_INTRINSICS.
#define NL_HPI_INV 0x1.45F306DC9C883p+23
#define NL_HPI 0x1.921FB54442D18p0
#define NL_C0 0x1p0
#define NL_C1 -0x1.ffffffd0c621cp-2
#define NL_C2 0x1.55553e1068f19p-5
#define NL_C3 -0x1.6c087e89a359dp-10
#define NL_C4 0x1.99343027bf8c3p-16
#define NL_S1 -0x1.555545995a603p-3
#define NL_S2 0x1.1107605230bc4p-7
#define NL_S3 -0x1.994eb3774cf24p-13
// 2 pi * 2^-64
#define NL_PI63 0x1.921FB54442D18p-62

// The sine (n even) or the cosine (n odd) polynomial of x, x2 = x * x;
// neg negates the cosine polynomial (the table's second entry).
NL_TRIG_FN float sinf_poly(double x, double x2, bool neg, int n) {
  if ((n & 1) == 0) {
    const double x3 = x * x2;
    const double s1 = NL_FMA(x2, NL_S3, NL_S2);
    const double x7 = x3 * x2;
    const double s = NL_FMA(x3, NL_S1, x);
    return (float)NL_FMA(x7, s1, s);
  }
  const double sg = neg ? -1.0 : 1.0;
  const double x4 = x2 * x2;
  const double c2 = NL_FMA(x2, sg * NL_C4, sg * NL_C3);
  const double c1 = NL_FMA(x2, sg * NL_C1, sg * NL_C0);
  const double x6 = x4 * x2;
  const double c = NL_FMA(x4, sg * NL_C2, c1);
  return (float)NL_FMA(x6, c2, c);
}

// x reduced to [-pi/4, pi/4] for |x| < 120; the quadrant into *np.
NL_TRIG_FN double reduce_fast(double x, int* np) {
  const double r = x * NL_HPI_INV;
  const int n = ((int32_t)r + 0x800000) >> 24;
  *np = n;
  return NL_FMA(-(double)n, NL_HPI, x);
}

// xi (a float's bits, |x| >= 120) reduced by the 4/pi table.
NL_TRIG_FN double reduce_large(uint32_t xi, int* np) {
  // 4/pi to 192 bits; each entry adds 8 bits
  const uint32_t inv_pio4[24] = {
      0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
      0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
      0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
      0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};
  const uint32_t* arr = &inv_pio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  uint64_t n, res0, res1, res2;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  res0 = xi * arr[0];
  res1 = (uint64_t)xi * arr[4];
  res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  const double x = (double)(int64_t)res0;
  *np = (int)n;
  return x * NL_PI63;
}

NL_TRIG_FN double quadrant_sign(int q) { return (q & 3) == 1 || (q & 3) == 2 ? -1.0 : 1.0; }

NL_TRIG_FN float sinf(float y) {
  double x = y;
  int n;
  if (abstop12(y) < abstop12(0x1.921FB6p-1f)) {
    if (abstop12(y) < abstop12(0x1p-12f)) return y;
    return sinf_poly(x, x * x, false, 0);
  }
  if (abstop12(y) < abstop12(120.0f)) {
    x = reduce_fast(x, &n);
    const double s = quadrant_sign(n);
    return sinf_poly(x * s, x * x, (n & 2) != 0, n);
  }
  if (abstop12(y) < abstop12(__builtin_inff())) {
    const uint32_t xi = asuint(y);
    const int sign = xi >> 31;
    x = reduce_large(xi, &n);
    const double s = quadrant_sign(n + sign);
    return sinf_poly(x * s, x * x, ((n + sign) & 2) != 0, n);
  }
  return (y - y) / (y - y);  // NaN for inf and NaN
}

NL_TRIG_FN float cosf(float y) {
  double x = y;
  int n;
  if (abstop12(y) < abstop12(0x1.921FB6p-1f)) {
    if (abstop12(y) < abstop12(0x1p-12f)) return 1.0f;
    return sinf_poly(x, x * x, false, 1);
  }
  if (abstop12(y) < abstop12(120.0f)) {
    x = reduce_fast(x, &n);
    const double s = quadrant_sign(n);
    return sinf_poly(x * s, x * x, (n & 2) != 0, n ^ 1);
  }
  if (abstop12(y) < abstop12(__builtin_inff())) {
    const uint32_t xi = asuint(y);
    const int sign = xi >> 31;
    x = reduce_large(xi, &n);
    const double s = quadrant_sign(n + sign);
    return sinf_poly(x * s, x * x, ((n + sign) & 2) != 0, n ^ 1);
  }
  return (y - y) / (y - y);
}

// fdlibm s_atanf.c, glibc's bound of 2^25 for the constant branch (its
// libm compares |x| with 0x4bffffff)
NL_TRIG_FN float atanf(float x) {
  const float atanhi[4] = {4.6364760399e-01f, 7.8539812565e-01f, 9.8279368877e-01f,
                           1.5707962513e+00f};
  const float atanlo[4] = {5.0121582440e-09f, 3.7748947079e-08f, 3.4473217170e-08f,
                           7.5497894159e-08f};
  const float aT0 = 3.3333334327e-01f, aT1 = -2.0000000298e-01f, aT2 = 1.4285714924e-01f,
              aT3 = -1.1111110449e-01f, aT4 = 9.0908870101e-02f, aT5 = -7.6918758452e-02f,
              aT6 = 6.6610731184e-02f, aT7 = -5.8335702866e-02f, aT8 = 4.9768779427e-02f,
              aT9 = -3.6531571299e-02f, aT10 = 1.6285819933e-02f;
  float w, s1, s2, z;
  int id;
  const int32_t hx = (int32_t)asuint(x);
  const int32_t ix = hx & 0x7fffffff;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return x + x;
    return hx > 0 ? atanhi[3] + atanlo[3] : -atanhi[3] - atanlo[3];
  }
  if (ix < 0x3ee00000) {  // |x| < 0.4375
    if (ix < 0x31000000) return x;  // |x| < 2^-29
    id = -1;
  } else {
    x = asfloat((uint32_t)ix);
    if (ix < 0x3f980000) {    // |x| < 1.1875
      if (ix < 0x3f300000) {  // 7/16 <= |x| < 11/16
        id = 0;
        x = (2.0f * x - 1.0f) / (2.0f + x);
      } else {  // 11/16 <= |x| < 19/16
        id = 1;
        x = (x - 1.0f) / (x + 1.0f);
      }
    } else {
      if (ix < 0x401c0000) {  // |x| < 2.4375
        id = 2;
        x = (x - 1.5f) / (1.0f + 1.5f * x);
      } else {  // 2.4375 <= |x| < 2^25
        id = 3;
        x = -1.0f / x;
      }
    }
  }
  z = x * x;
  w = z * z;
  s1 = z * (aT0 + w * (aT2 + w * (aT4 + w * (aT6 + w * (aT8 + w * aT10)))));
  s2 = w * (aT1 + w * (aT3 + w * (aT5 + w * (aT7 + w * aT9))));
  if (id < 0) return x - x * (s1 + s2);
  z = atanhi[id] - ((x * (s1 + s2) - atanlo[id]) - x);
  return hx < 0 ? -z : z;
}

// fdlibm e_atan2f.c
NL_TRIG_FN float atan2f(float y, float x) {
  const float tiny = 1.0e-30f, pi_o_4 = 7.8539818525e-01f, pi_o_2 = 1.5707963705e+00f,
              pi = 3.1415927410e+00f, pi_lo = -8.7422776573e-08f;
  float z;
  const int32_t hx = (int32_t)asuint(x);
  const int32_t ix = hx & 0x7fffffff;
  const int32_t hy = (int32_t)asuint(y);
  const int32_t iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;  // NaN
  if (hx == 0x3f800000) return atanf(y);                  // x = 1.0
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);      // 2 * sign(x) + sign(y)
  if (iy == 0) {
    switch (m) {
      case 0:
      case 1: return y;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (ix == 0) return hy < 0 ? -pi_o_2 - tiny : pi_o_2 + tiny;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return pi_o_4 + tiny;
        case 1: return -pi_o_4 - tiny;
        case 2: return 3.0f * pi_o_4 + tiny;
        default: return -3.0f * pi_o_4 - tiny;
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? -pi_o_2 - tiny : pi_o_2 + tiny;
  const int k = (iy - ix) >> 23;
  if (k > 60) {
    z = pi_o_2 + 0.5f * pi_lo;
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    z = atanf(asfloat(asuint(y / x) & 0x7fffffffu));
  }
  switch (m) {
    case 0: return z;
    case 1: return asfloat(asuint(z) ^ 0x80000000u);
    case 2: return pi - (z - pi_lo);
    default: return (z - pi_lo) - pi;
  }
}

}  // namespace nl_trig
