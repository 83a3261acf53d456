"""Port parity: a pose's rays, ``se3.pose_rays`` (csrc/pose_rays.cu; its twin
``pose_rays_plain`` on the CPU), against the JAX package on the CPU:
BA's ``vmap(se3.rotate_dirs)`` and the broadcast translation
(nerfloam_tpu/core/ba.py:253-256) for windows of W = 1, 2 and 4 frames, and
the trackers' one pose (nerfloam_tpu/core/tracking.py:249, 436), with poses
on both sides of exp_so3's small-angle switch (theta^2 < 1e-8).

- Forward: the origins equal JAX's broadcast; R bit-equal to JAX's op-by-op
  exp_so3; the directions, given JAX's jitted rotation matrices, bit-equal
  to JAX's jitted rotate_dirs (the product is XLA's fma chain, and torch's
  CPU product, which the port took before, is too); with the port's own R
  within 3 ulp of each ray's largest entry (jitted XLA rounds exp_so3's
  chain otherwise than its op-by-op form), the small-angle poses' rays
  bit-equal. One frame's origins are its t expanded (row stride 0).
- Backward: the poses' gradient from seeded cotangents of the origins and
  the directions, autograd through the twin against ``jax.vjp`` of JAX's
  form, within 1e-5 of each pose's largest entry (the sums over the rays
  run in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.ops import se3 as tse3

torch.set_num_threads(2)
N = 512


def _case(W, seed):
    """W poses 10 m out, alternately small-angle (theta ~ 5e-5: the series
    branch) and 0.5-1 rad; N unit directions a frame."""
    rng = np.random.default_rng(seed)
    n = max(W, 1)
    w = rng.normal(size=(n, 3)) * np.where(np.arange(n) % 2 == 0, 3e-5, 0.5)[:, None]
    poses = np.concatenate([rng.normal(0, 10, (n, 3)), w], 1).astype(np.float32)
    dirs = rng.normal(size=(n, N, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return (poses[0], dirs[0]) if W == 0 else (poses, dirs)


def _jax_rays(poses, dirs):
    """ba.py:253-256 (W, 6) -> rows, or tracking.py:249 for one pose."""
    if poses.ndim == 1:
        wdirs = jse3.rotate_dirs(poses, dirs)
        return jnp.broadcast_to(jse3.pose_translation(poses), wdirs.shape), wdirs
    wdirs = jax.vmap(jse3.rotate_dirs)(poses, dirs)
    origins = jnp.broadcast_to(jse3.pose_translation(poses)[:, None, :], wdirs.shape)
    return origins.reshape(-1, 3), wdirs.reshape(-1, 3)


@pytest.mark.parametrize("W", [0, 1, 2, 4])
def test_pose_rays_forward_matches_jax(W):
    poses, dirs = _case(W, W)
    jo, jw = (np.asarray(x) for x in jax.jit(_jax_rays)(jnp.asarray(poses), jnp.asarray(dirs)))
    o, w, R = tse3.pose_rays(torch.as_tensor(poses), torch.as_tensor(dirs), with_R=True)
    np.testing.assert_array_equal(o.numpy(), jo)
    assert (o.stride(0) == 0) == (poses.ndim == 1 or len(poses) == 1)
    rot = jax.vmap(jse3.pose_rotation) if poses.ndim == 2 else jse3.pose_rotation
    np.testing.assert_array_equal(R.numpy(), np.asarray(rot(jnp.asarray(poses))))
    jit_R = torch.as_tensor(np.asarray(jax.jit(rot)(jnp.asarray(poses))))
    np.testing.assert_array_equal(
        tse3.rotate_rows(torch.as_tensor(dirs), jit_R).numpy().reshape(jw.shape), jw)
    # the product the port took before on the CPU: the same bits
    before = torch.matmul(torch.as_tensor(dirs), R.transpose(-1, -2))
    np.testing.assert_array_equal(w.numpy(), before.numpy().reshape(w.shape))
    ray_ulp = np.spacing(np.abs(jw).max(-1, keepdims=True).astype(np.float32))
    off = np.abs(w.numpy().astype(np.float64) - jw) / ray_ulp
    small = np.repeat(np.arange(max(W, 1)) % 2 == 0, N)
    print(f"[pose_rays] W = {W}: rays within {off.max():g} ulp of each ray's largest entry of "
          f"JAX's jitted form, bit-equal {(w.numpy() == jw).all(-1).mean():.4f}")
    assert off.max() <= 3.0
    np.testing.assert_array_equal(w.numpy()[small], jw[small])


@pytest.mark.parametrize("W", [0, 1, 2, 4])
def test_pose_rays_backward_matches_jax_vjp(W):
    poses, dirs = _case(W, 10 + W)
    rng = np.random.default_rng(20 + W)
    rows = max(W, 1) * N
    go, gd = (rng.normal(size=(rows, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda p, d, c: jax.vjp(lambda q: _jax_rays(q, d), p)[1](c)[0])(
        jnp.asarray(poses), jnp.asarray(dirs), (jnp.asarray(go), jnp.asarray(gd)))
    p = torch.as_tensor(poses).requires_grad_(True)
    o, w = tse3.pose_rays(p, torch.as_tensor(dirs))
    (got,) = torch.autograd.grad((o, w), p, (torch.as_tensor(go), torch.as_tensor(gd)))
    want = np.asarray(want).reshape(-1, 6)
    rel = (np.abs(got.numpy().reshape(-1, 6).astype(np.float64) - want).max(-1)
           / np.abs(want).max(-1))
    print(f"[pose_rays] W = {W}: the poses' gradient within {rel.max():.3g} of each pose's "
          "largest entry of jax.vjp's")
    assert rel.max() <= 1e-5


def test_pose_rays_checks_its_inputs():
    p, d = torch.zeros(2, 6), torch.zeros(2, 8, 3)
    for bad in ((p.double(), d), (p[:, :5], d), (p, d[:1]), (p, d[..., :2]),
                (p[0], d), (p, d.transpose(0, 1).contiguous().transpose(0, 1)),
                (p, d.clone().requires_grad_(True))):
        with pytest.raises(ValueError):
            tse3.pose_rays(*bad)
