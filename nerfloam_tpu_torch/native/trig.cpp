// The port's host copies of sinf, cosf and atan2f (trig.h), over arrays:
// the CPU path of ops/trig.py and the plain twin of csrc/trig.cu. They do
// not call the host's libm, so a host with another glibc rounds as this
// copy does. Built by native/__init__.py with -ffp-contract=off.

#include "trig.h"

extern "C" {

int nl_sinf_n(const float* x, long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = nl_trig::sinf(x[i]);
  return 0;
}

int nl_cosf_n(const float* x, long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = nl_trig::cosf(x[i]);
  return 0;
}

int nl_atan2f_n(const float* y, const float* x, long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = nl_trig::atan2f(y[i], x[i]);
  return 0;
}

}  // extern "C"
