"""Port parity: the LM pose step of the GN tracker against the JAX
package on the CPU.

- ``tracking.lm_step_plain`` (csrc/lm_step.cu's twin; what ``lm_step``
  takes on the CPU) on 2,000 seeded (pose, solve solution) pairs in exp_so3's
  series branch and 2,000 in its exact branch, one step a call as the
  tracker takes it: bit-equal to the chain ``lm_update`` ran after the
  solve before it was moved (trust region, exp_so3, compose, log_so3, the
  translation added), its rotation matrix ``se3.pose_rotation`` of the new
  pose; the translation bit-equal to JAX's step run op by op, the rotation
  within 1e-5 of JAX's jitted step (test_torch_ops' se3 tolerance) and,
  in ulp of its largest entry, bit-equal in the series branch and within
  5 in the exact one (the sine, cosine and atan2 are glibc's, ops/trig;
  what is left is XLA's fusion of the jitted step), bit-equal to JAX's step
  run op by op in both; the share of rotation entries bit-equal printed.
  Under jit XLA fuses the translation's scale into its add: ~1% of
  translations differ there by an ulp.
- exp_so3's coefficient B = (1 - cos t) / t^2 against JAX's on 100,000
  seeded t^2 in each of three ranges: bit-equal everywhere, the root
  rounded once and the cosine glibc's (ops/trig); torch's f32 cosine misses
  on 5-10%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import se3 as tse3

torch.set_num_threads(2)


@pytest.mark.parametrize("lo, hi, most", [(1e-8, 1e-6, 0), (1e-6, 1e-2, 0), (1e-2, 0.25, 0)])
def test_sinc_coeffs_cosine_matches_jax(lo, hi, most):
    """B bit-equal to JAX's on all of 100,000 seeded t^2 in (lo, hi); torch's
    f32 cosine in its place misses on thousands."""
    t2 = np.random.default_rng(2).uniform(lo, hi, 100000).astype(np.float32)
    _, jb = jse3._sinc_coeffs(jnp.asarray(t2))
    _, b = tse3._sinc_coeffs(torch.as_tensor(t2))
    differ = int((b.numpy() != np.asarray(jb)).sum())
    theta = torch.sqrt(torch.as_tensor(t2))
    f32_cos = (1.0 - torch.cos(theta)) / torch.as_tensor(t2)
    f32_differ = int((f32_cos.numpy() != np.asarray(jb)).sum())
    print(f"[sinc] t^2 in ({lo:g}, {hi:g}): B differs from JAX's on {differ} of 100,000, "
          f"with torch's f32 cosine on {f32_differ}")
    assert differ <= most and f32_differ > 5000


def _steps(n, branch, seed=0):
    """n (pose, solve solution) pairs: poses 10 m from the origin, translation
    steps of 1 mm to 1 m (some clipped to 0.5 m); rotations and rotation
    steps under 1e-4 rad (series) or of 0.8 and 0.05 rad (exact)."""
    rng = np.random.default_rng(seed)
    w, dw = (3e-5, 3e-5) if branch == "series" else (0.8, 0.05)
    pose = np.concatenate([rng.normal(0, 10, (n, 3)), rng.normal(0, w, (n, 3))], 1)
    step = np.concatenate([rng.normal(0, 0.3, (n, 3)) * np.exp(rng.uniform(-6, 1, (n, 1))),
                           rng.normal(0, dw, (n, 3))], 1)
    return pose.astype(np.float32), step.astype(np.float32)


def _chain_before(pose6, step):
    """tracking.lm_update's chain after the solve, as it ran before it moved
    into lm_step_plain (the trust region on one (6,) step)."""
    delta = -step
    dt, dth = delta[:3], delta[3:]
    dt = dt * torch.clamp(ieee.rdiv(0.5, ieee.norm3(dt) + 1e-12), max=1.0)
    dth = dth * torch.clamp(ieee.rdiv(0.1, ieee.norm3(dth) + 1e-12), max=1.0)
    R_new = tse3.compose_matrices(tse3.exp_so3(dth), tse3.pose_rotation(pose6))
    return torch.cat([pose6[:3] + dt, tse3.log_so3(R_new)])


def _jax_step(pose6, step):
    """JAX's LM update after the solve, nerfloam_tpu/core/tracking.py:326-334."""
    delta = -step
    dt, dth = delta[:3], delta[3:]
    dt = dt * jnp.minimum(1.0, 0.5 / (jnp.linalg.norm(dt) + 1e-12))
    dth = dth * jnp.minimum(1.0, 0.1 / (jnp.linalg.norm(dth) + 1e-12))
    R_new = jse3.compose_matrices(jse3.exp_so3(dth), jse3.pose_rotation(pose6))
    return jnp.concatenate([pose6[:3] + dt, jse3.log_so3(R_new)])


@pytest.fixture(scope="module")
def steps():
    """{branch: (poses, solutions, lm_step_plain's poses, its rotations)}."""
    out = {}
    for branch in ("series", "exact"):
        pose, step = _steps(2000, branch)
        got = [ttr.lm_step_plain(torch.as_tensor(p), torch.as_tensor(s_))
               for p, s_ in zip(pose, step)]
        out[branch] = (pose, step, np.stack([g.numpy() for g, _ in got]),
                       np.stack([R.numpy() for _, R in got]))
    return out


@pytest.mark.parametrize("branch", ["series", "exact"])
def test_lm_step_plain_is_the_chain_it_replaced(steps, branch):
    """lm_step_plain, one step a call, bit-equal to lm_update's chain after
    the solve as it was, and its rotation the new pose's pose_rotation; the
    CPU's lm_step is lm_step_plain."""
    pose, step, got, rot = steps[branch]
    before = np.stack([_chain_before(torch.as_tensor(p), torch.as_tensor(s_)).numpy()
                       for p, s_ in zip(pose, step)])
    np.testing.assert_array_equal(got, before)
    np.testing.assert_array_equal(rot, np.stack([tse3.pose_rotation(torch.as_tensor(g)).numpy()
                                                 for g in got]))
    for i in (0, 7, 1999):
        p, s_ = torch.as_tensor(pose[i]), torch.as_tensor(step[i])
        a, R = ttr.lm_step(p, s_)
        assert torch.equal(a, torch.as_tensor(got[i])) and torch.equal(R, torch.as_tensor(rot[i]))


def _rot_ulps(got, ref):
    """The largest |got - ref| of the rotations in ulp of each reference
    rotation's largest entry."""
    ulp = np.spacing(np.abs(ref[:, 3:]).max(1, keepdims=True).astype(np.float32))
    return float((np.abs(got[:, 3:].astype(np.float64) - ref[:, 3:]) / ulp).max())


@pytest.mark.parametrize("branch", ["series", "exact"])
def test_lm_step_plain_matches_jax(steps, branch):
    """The translation bit-equal to JAX's step op by op; the rotation within
    1e-5 of JAX's jitted step, and in ulp of the rotation's largest entry
    (rotations of ~4e-5 rad in the series branch, where 1e-5 would be a
    quarter of them): bit-equal to the jitted and the op-by-op step in the
    series branch (no sine); in the exact branch bit-equal to the op-by-op
    step and within 5 ulp of the jitted one (measured 5: XLA's fusion); the
    share of bit-equal entries printed."""
    pose, step, got, _ = steps[branch]
    eager = np.stack([np.asarray(_jax_step(jnp.asarray(p), jnp.asarray(s_)))
                      for p, s_ in zip(pose[:500], step[:500])])
    np.testing.assert_array_equal(got[:500, :3], eager[:, :3])
    jit_step = jax.jit(_jax_step)
    ref = np.stack([np.asarray(jit_step(jnp.asarray(p), jnp.asarray(s_)))
                    for p, s_ in zip(pose, step)])
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=1e-5, atol=1e-5)
    if branch == "series":
        np.testing.assert_array_equal(got[:, 3:], ref[:, 3:])
        np.testing.assert_array_equal(got[:500, 3:], eager[:, 3:])
    else:
        np.testing.assert_array_equal(got[:500, 3:], eager[:, 3:])
        assert _rot_ulps(got, ref) <= 5
    assert np.abs(got[:, :3] - ref[:, :3]).max() <= np.spacing(np.abs(ref[:, :3]).max())
    print(f"[lm_step] {branch}: rotation entries bit-equal to JAX's jitted step "
          f"{(got[:, 3:] == ref[:, 3:]).mean():.4f}, to its op-by-op step "
          f"{(got[:500, 3:] == eager[:, 3:]).mean():.4f} (largest gaps {_rot_ulps(got, ref):g} "
          f"and {_rot_ulps(got[:500], eager):g} ulp of the rotation's largest entry); "
          f"translations equal to the jitted step {(got[:, :3] == ref[:, :3]).all(1).mean():.4f}")
