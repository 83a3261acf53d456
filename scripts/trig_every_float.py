"""Every float of [0, pi]: the port's host sin and cos (native/trig.h, through
``ops/trig``) against this host's libm ``sinf`` / ``cosf`` (the functions
XLA's CPU backend calls for jnp.sin / jnp.cos), bit for bit; then ``--pairs
N`` seeded atan2 pairs against ``atan2f``. Prints the counts that differ
and exits 1 if any does.

    python scripts/trig_every_float.py [--pairs 10000000]

About a minute on one core for the 1,078,530,012 floats.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from nerfloam_tpu_torch.ops import trig  # noqa: E402

SHIM = r"""
#include <math.h>
extern "C" {
void libm_sinf(const float* x, long n, float* o) { for (long i = 0; i < n; ++i) o[i] = sinf(x[i]); }
void libm_cosf(const float* x, long n, float* o) { for (long i = 0; i < n; ++i) o[i] = cosf(x[i]); }
void libm_atan2f(const float* y, const float* x, long n, float* o) {
  for (long i = 0; i < n; ++i) o[i] = atan2f(y[i], x[i]);
}
}
"""


def libm(workdir):
    """This host's libm through ctypes: three loops built by g++ without
    builtins, so that every call is libm's."""
    src, so = os.path.join(workdir, "shim.cpp"), os.path.join(workdir, "shim.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-fno-builtin", "-shared", "-fPIC", src, "-o", so, "-lm"],
                   check=True)
    lib = ctypes.CDLL(so)
    P, L = ctypes.c_void_p, ctypes.c_long
    lib.libm_sinf.argtypes = lib.libm_cosf.argtypes = [P, L, P]
    lib.libm_atan2f.argtypes = [P, P, L, P]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10_000_000, help="seeded atan2 pairs")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        lib = libm(d)
        last = int(np.float32(np.pi).view(np.uint32))
        chunk = 1 << 24
        differ = {"sin": 0, "cos": 0}
        t0 = time.perf_counter()
        for lo in range(0, last + 1, chunk):
            x = np.arange(lo, min(lo + chunk, last + 1), dtype=np.uint32).view(np.float32)
            ref = np.empty_like(x)
            for name, fn in (("sin", trig.sin), ("cos", trig.cos)):
                getattr(lib, f"libm_{name}f")(x.ctypes.data, x.size, ref.ctypes.data)
                got = fn(torch.from_numpy(x)).numpy()
                differ[name] += int((got.view(np.uint32) != ref.view(np.uint32)).sum())
        n = last + 1
        print(f"[trig] every float of [0, pi] ({n:,}): sin differs from libm on {differ['sin']}, "
              f"cos on {differ['cos']} ({time.perf_counter() - t0:.1f} s)")
        rng = np.random.default_rng(0)
        h = args.pairs // 2
        y = np.concatenate([rng.normal(size=h), rng.uniform(-1e3, 1e3, args.pairs - h)])
        x = np.concatenate([rng.normal(size=h), rng.uniform(-1e3, 1e3, args.pairs - h)])
        y, x = y.astype(np.float32), x.astype(np.float32)
        ref = np.empty_like(y)
        lib.libm_atan2f(y.ctypes.data, x.ctypes.data, y.size, ref.ctypes.data)
        got = trig.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
        differ["atan2"] = int((got.view(np.uint32) != ref.view(np.uint32)).sum())
        print(f"[trig] {args.pairs:,} seeded atan2 pairs: {differ['atan2']} differ from libm")
    return 1 if any(differ.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
