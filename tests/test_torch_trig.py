"""Port parity: sin, cos and atan2 as XLA's CPU backend rounds them.

XLA's CPU backend calls the host's libm for ``jnp.sin``, ``jnp.cos`` and
``jnp.arctan2``; the port's copies (``native/trig.h``, run on CPU tensors by
``ops/trig.py``; csrc/trig.cu and the kernels that include the header on the
card) must round every argument as that libm (glibc 2.36) does:

- bit-equal to libm, called through ctypes (a shim compiled here that loops
  over an array calling ``sinf`` / ``cosf`` / ``atan2f``), on every 64th
  float of [0, pi] and on 10^6 seeded atan2 pairs with the axes, zeros,
  signed infinities and NaN; ``scripts/trig_every_float.py`` checks every
  float of [0, pi];
- bit-equal to ``jax.jit(jnp.sin / jnp.cos / jnp.arctan2)`` on 80,000
  arguments each, and their backward to ``jax.vjp``; XLA runs with
  subnormals flushed to zero, so atan2 pairs with a subnormal operand or
  result (0.6% of the random bit patterns, none on the port's paths) are
  held to libm only;
- the port's ``exp_so3``, ``log_so3`` and ``lm_step_plain`` bit-equal to
  JAX's (run op by op) on seeded inputs of both exp_so3 branches;
- the range image's azimuth, elevation and pixel ids bit-equal to JAX's
  (core/scan2scan.py:73-75, 104-110) on seeded scans: the angles to the
  jitted ``_angles``, the pixel ids to JAX's op-by-op arithmetic (under jit
  XLA turns the division by 2 pi into a product by its reciprocal, which
  moves a few points across an azimuth bin: printed).
"""

import ctypes
import math
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core import scan2scan as js2s
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import scan2scan as ts2s
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.ops import trig

torch.set_num_threads(2)

_SHIM = r"""
#include <math.h>
extern "C" {
void libm_sinf(const float* x, long n, float* o) { for (long i = 0; i < n; ++i) o[i] = sinf(x[i]); }
void libm_cosf(const float* x, long n, float* o) { for (long i = 0; i < n; ++i) o[i] = cosf(x[i]); }
void libm_atan2f(const float* y, const float* x, long n, float* o) {
  for (long i = 0; i < n; ++i) o[i] = atan2f(y[i], x[i]);
}
}
"""


@pytest.fixture(scope="module")
def libm(tmp_path_factory):
    """The host's libm through ctypes: a shim of three loops, built by g++
    without builtins, so that every call is libm's."""
    d = tmp_path_factory.mktemp("libm")
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run(["g++", "-O2", "-fno-builtin", "-shared", "-fPIC", str(d / "shim.cpp"),
                    "-o", str(d / "shim.so"), "-lm"], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    P, L = ctypes.c_void_p, ctypes.c_long
    lib.libm_sinf.argtypes = lib.libm_cosf.argtypes = [P, L, P]
    lib.libm_atan2f.argtypes = [P, P, L, P]

    def call(name, *xs):
        xs = [np.ascontiguousarray(x, np.float32) for x in xs]
        out = np.empty_like(xs[0])
        getattr(lib, f"libm_{name}")(*(x.ctypes.data for x in xs), out.size, out.ctypes.data)
        return out

    return call


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _subnormal(a):
    return (a != 0) & (np.abs(a) < np.finfo(np.float32).tiny)


def _port(fn, *xs):
    return fn(*(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in xs)).numpy()


def _atan2_pairs(n, seed):
    """n seeded (y, x) pairs: half normal, half random bit patterns (every
    magnitude and NaN), then every pair of the specials."""
    rng = np.random.default_rng(seed)
    h = n // 2
    y = np.concatenate([rng.normal(size=h).astype(np.float32),
                        rng.integers(0, 2 ** 32, n - h, dtype=np.uint64).astype(np.uint32)
                        .view(np.float32)])
    x = np.concatenate([rng.normal(size=h).astype(np.float32),
                        rng.integers(0, 2 ** 32, n - h, dtype=np.uint64).astype(np.uint32)
                        .view(np.float32)])
    sp = np.asarray([0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 2.0, -3.0, 3.4e38, -3.4e38, np.inf,
                     -np.inf, np.nan], np.float32)
    sy, sx = np.meshgrid(sp, sp)
    return np.concatenate([y, sy.ravel()]), np.concatenate([x, sx.ravel()])


def test_sin_cos_match_libm_on_every_64th_float(libm):
    x = np.arange(0, int(_bits(np.float32(np.pi))) + 1, 64, dtype=np.uint32).view(np.float32)
    for name, fn in (("sinf", trig.sin), ("cosf", trig.cos)):
        got, ref = _port(fn, x), libm(name, x)
        differ = int((_bits(got) != _bits(ref)).sum())
        assert differ == 0, f"{name}: {differ} of {x.size} floats differ from libm"


def test_atan2_matches_libm_on_seeded_pairs(libm):
    y, x = _atan2_pairs(1_000_000, 0)
    got, ref = _port(trig.atan2, y, x), libm("atan2f", y, x)
    same = (_bits(got) == _bits(ref)) | (np.isnan(got) & np.isnan(ref))
    assert same.all(), f"{int((~same).sum())} of {y.size} pairs differ from libm"


def test_match_jax_jit_and_its_vjp():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(0, np.pi, 40000), rng.normal(0, 30, 40000)]).astype(np.float32)
    y, z = _atan2_pairs(80000, 2)
    g = rng.normal(size=80000).astype(np.float32)
    for name, jf, tf, args in (("sin", jnp.sin, trig.sin, (x,)), ("cos", jnp.cos, trig.cos, (x,)),
                               ("atan2", jnp.arctan2, trig.atan2, (y, z))):
        ref = np.asarray(jax.jit(jf)(*args))
        got = _port(tf, *args)
        same = (_bits(got) == _bits(ref)) | (np.isnan(got) & np.isnan(ref))
        normal = ~np.any([_subnormal(a) for a in (*args, got)], axis=0)
        assert normal.mean() > 0.95 and same[normal].all(), \
            f"{name}: {int((~same[normal]).sum())} differ from jax.jit"
        if name == "atan2":  # the gradient on the normal half (squares neither flush nor overflow)
            args = tuple(a[:40000] for a in args)
        gg = g[:args[0].size]
        jg = jax.jit(lambda *a: jax.vjp(jf, *a)[1](gg))(*args)
        ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
        tg = torch.autograd.grad(tf(*ts), ts, torch.from_numpy(gg))
        for k, (j, t) in enumerate(zip(jg, tg)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"{name} d{k}")


def _rotations(n, branch, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 3e-5 if branch == "series" else 0.9, (n, 3)).astype(np.float32)
    return w


@pytest.mark.parametrize("branch", ["series", "exact"])
def test_exp_log_so3_match_jax(branch):
    """exp_so3 of 2,000 seeded rotation vectors and log_so3 of their
    matrices (and of rotations near pi) bit-equal to JAX's."""
    w = _rotations(2000, branch, 3)
    R = tse3.exp_so3(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(R, np.asarray(jse3.exp_so3(jnp.asarray(w))))
    if branch == "exact":  # angles up to pi
        a = np.random.default_rng(4).normal(size=(500, 3))
        a = (a / np.linalg.norm(a, axis=1, keepdims=True) * np.random.default_rng(5).uniform(
            2.5, np.pi, (500, 1))).astype(np.float32)
        R = np.concatenate([R, tse3.exp_so3(torch.from_numpy(a)).numpy()])
    got = tse3.log_so3(torch.from_numpy(R)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jse3.log_so3(jnp.asarray(R))))


@pytest.mark.parametrize("branch", ["series", "exact"])
def test_lm_step_plain_matches_jax_op_by_op(branch):
    """The GN tracker's LM step (trust region, exp_so3, compose, log_so3)
    on 200 seeded (pose, solution) pairs, bit-equal to JAX's op by op."""
    rng = np.random.default_rng(6)
    n = 200
    w, dw = (3e-5, 3e-5) if branch == "series" else (0.8, 0.05)
    pose = np.concatenate([rng.normal(0, 10, (n, 3)), rng.normal(0, w, (n, 3))], 1)
    step = np.concatenate([rng.normal(0, 0.3, (n, 3)), rng.normal(0, dw, (n, 3))], 1)
    pose, step = pose.astype(np.float32), step.astype(np.float32)
    got = np.stack([ttr.lm_step_plain(torch.from_numpy(p), torch.from_numpy(s))[0].numpy()
                    for p, s in zip(pose, step)])

    def jax_step(pose6, st):
        delta = -st
        dt, dth = delta[:3], delta[3:]
        dt = dt * jnp.minimum(1.0, 0.5 / (jnp.linalg.norm(dt) + 1e-12))
        dth = dth * jnp.minimum(1.0, 0.1 / (jnp.linalg.norm(dth) + 1e-12))
        R_new = jse3.compose_matrices(jse3.exp_so3(dth), jse3.pose_rotation(pose6))
        return jnp.concatenate([pose6[:3] + dt, jse3.log_so3(R_new)])

    ref = np.stack([np.asarray(jax_step(jnp.asarray(p), jnp.asarray(s)))
                    for p, s in zip(pose, step)])
    np.testing.assert_array_equal(got, ref)


def test_range_image_angles_and_pixels_match_jax():
    """Azimuth, elevation and each point's pixel (elevation bin x A +
    azimuth bin) of three seeded scans, bit-equal to JAX's."""
    B, A = 64, 1024
    for seed in range(3):
        rng = np.random.default_rng(10 + seed)
        n = 20000
        az0, el0 = rng.uniform(-np.pi, np.pi, n), rng.uniform(-0.43, 0.05, n)
        r = rng.uniform(1.0, 60.0, n)
        pts = np.stack([r * np.cos(el0) * np.cos(az0), r * np.cos(el0) * np.sin(az0),
                        r * np.sin(el0)], 1).astype(np.float32)
        pts[:50, :2] = 0.0  # on the axis
        jaz, jel, _ = (np.asarray(a) for a in jax.jit(js2s._angles)(jnp.asarray(pts)))
        taz, tel, _ = (a.numpy() for a in ts2s._angles(torch.from_numpy(pts)))
        np.testing.assert_array_equal(taz, jaz)
        np.testing.assert_array_equal(tel, jel)
        e_min, e_max = np.float32(tel.min()), np.float32(tel.max())
        e_lo, e_hi = np.asarray(e_min), np.asarray(e_max)

        def jax_pix(az, el):
            span = jnp.maximum(e_max - e_min, 1e-3)
            bi = jnp.clip(((el - e_min) / span * (B - 1)).astype(jnp.int32), 0, B - 1)
            ai = jnp.clip(((az + jnp.pi) / (2 * jnp.pi) * A).astype(jnp.int32), 0, A - 1)
            return bi * A + ai

        jp = np.asarray(jax_pix(jnp.asarray(jaz), jnp.asarray(jel)))  # op by op
        jit_differ = int((np.asarray(jax.jit(jax_pix)(jnp.asarray(jaz), jnp.asarray(jel)))
                          != jp).sum())
        print(f"[range image] seed {seed}: pixel ids of JAX's jitted form differ from its "
              f"op-by-op form on {jit_differ} of {n} (XLA multiplies by 1 / (2 pi))")
        t = torch.from_numpy
        tp = (ts2s._bin(ts2s._elev_bin_f(t(tel), t(e_lo), t(e_hi), B), B) * A
              + ts2s._az_bin(t(taz), A)).numpy()
        np.testing.assert_array_equal(tp, jp)
        assert math.isfinite(float(e_min)) and len(np.unique(tp)) > 1000
