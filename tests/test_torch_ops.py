"""Port parity: ops/se3, ops/interp, models/decoder, core/losses and
ops/sampling of nerfloam_tpu_torch against the JAX package, on the same
numpy inputs. Tolerance: 1e-5 in float32 (the functions are elementwise or
tiny matmuls; only the summation order differs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfloam_tpu.core import losses as jlosses
from nerfloam_tpu.models import decoder as jdec
from nerfloam_tpu.ops import interp as jinterp
from nerfloam_tpu.ops import sampling as jsampling
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import losses as tlosses
from nerfloam_tpu_torch.models import decoder as tdec
from nerfloam_tpu_torch.ops import interp as tinterp
from nerfloam_tpu_torch.ops import sampling as tsampling
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.utils.bridge import decoder_params_from_jax, to_numpy

torch.set_num_threads(2)
TOL = 1e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=tol, atol=tol)


def _poses(n=16, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 6)).astype(np.float32)
    p[: n // 4, 3:] *= 1e-5  # small-angle branch
    p[n // 4: n // 2, 3:] *= 3.0  # large angles, near pi
    return p


@pytest.mark.parametrize("fn", ["exp_so3", "pose_matrix", "rotate", "transform",
                                "inv_transform", "compose", "invert", "log_so3"])
def test_se3_matches_jax(fn):
    p6 = _poses()
    pts = np.random.default_rng(1).normal(size=(16, 5, 3)).astype(np.float32) * 10
    jp, tp = jnp.asarray(p6), torch.as_tensor(p6)
    if fn == "exp_so3":
        _close(tse3.exp_so3(tp[:, 3:]), jse3.exp_so3(jp[:, 3:]))
    elif fn == "pose_matrix":
        _close(tse3.pose_matrix(tp), jse3.pose_matrix(jp))
    elif fn == "rotate":
        _close(tse3.rotate_dirs(tp, torch.as_tensor(pts)), jse3.rotate_dirs(jp, jnp.asarray(pts)),
               1e-4)
    elif fn == "transform":
        _close(tse3.transform_points(tp, torch.as_tensor(pts)),
               jse3.transform_points(jp, jnp.asarray(pts)), 1e-4)
    elif fn == "inv_transform":
        _close(tse3.inv_transform_points(tp, torch.as_tensor(pts)),
               jse3.inv_transform_points(jp, jnp.asarray(pts)), 1e-4)
    elif fn == "compose":
        A, B = jse3.pose_matrix(jp), jse3.pose_matrix(jp[::-1])
        _close(tse3.compose_matrices(torch.as_tensor(np.asarray(A)), torch.as_tensor(np.asarray(B))),
               jse3.compose_matrices(A, B))
    elif fn == "invert":
        T = jse3.pose_matrix(jp)
        _close(tse3.invert_matrix(torch.as_tensor(np.asarray(T))), jse3.invert_matrix(T))
    else:
        T = np.asarray(jse3.pose_matrix(jp))
        _close(tse3.pose_from_matrix(torch.as_tensor(T)), jse3.pose_from_matrix(jnp.asarray(T)),
               1e-4)


def test_exp_so3_grad_finite_at_zero():
    w = torch.zeros(3, requires_grad=True)
    tse3.exp_so3(w).sum().backward()
    g = jax.grad(lambda x: jnp.sum(jse3.exp_so3(x)))(jnp.zeros(3))
    assert torch.isfinite(w.grad).all()
    _close(w.grad, g)


def test_interp_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.uniform(size=(50, 3)).astype(np.float32)
    _close(tinterp.trilinear_weights(torch.as_tensor(p)),
           jinterp.trilinear_weights(jnp.asarray(p)))
    vs = 0.4
    center = (np.floor(rng.normal(size=(50, 3)) * 5) + 0.5).astype(np.float32) * vs
    xyz = (center + rng.uniform(-0.5, 0.5, size=(50, 3)) * vs).astype(np.float32)
    feats = rng.normal(size=(50, 8, 16)).astype(np.float32)
    _close(tinterp.interp_corner_features(torch.as_tensor(xyz), torch.as_tensor(center),
                                          torch.as_tensor(feats), vs),
           jinterp.interp_corner_features(jnp.asarray(xyz), jnp.asarray(center),
                                          jnp.asarray(feats), vs))
    assert (tinterp.CORNER_OFFSETS == jinterp.CORNER_OFFSETS).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_matches_jax(dtype):
    params, meta = jdec.init_decoder(jax.random.key(0))
    tparams = decoder_params_from_jax(jax.device_get(params), device="cpu")
    feats = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
    ref = jdec.decoder_apply(params, meta, jnp.asarray(feats), getattr(jnp, dtype))
    got = tdec.decoder_apply(tparams, torch.as_tensor(feats), getattr(torch, dtype))
    # bf16: both sides round the same operands to bf16 and accumulate in f32;
    # a hidden activation that differs by one f32 ulp can round to the
    # neighbouring bf16 value, so the bf16 bound is one bf16 ulp-scale step
    _close(got, ref, TOL if dtype == "float32" else 1e-2)


def test_decoder_init_shapes_and_bounds():
    g = torch.Generator().manual_seed(0)
    params = tdec.init_decoder(generator=g, device="cpu")
    shapes = [tuple(w.shape) for w in params["w"]]
    assert shapes == [(16, 256), (256, 256), (256, 1)]
    for w in params["w"]:
        assert float(w.abs().max()) <= 1.0 / np.sqrt(w.shape[0])
    with pytest.raises(NotImplementedError):
        tdec.init_decoder(skips=(1,), device="cpu")


def test_sdf_losses_match_jax():
    rng = np.random.default_rng(4)
    R, M = 40, 12
    gt = rng.normal(size=(R, 3)).astype(np.float32) * 5
    d = np.linalg.norm(gt, axis=-1)
    z = (d[:, None] + rng.normal(size=(R, M)) * 0.6).astype(np.float32)
    sdf = rng.normal(size=(R, M)).astype(np.float32) * 0.3
    valid = rng.uniform(size=(R, M)) > 0.2
    ray_mask = rng.uniform(size=R) > 0.1
    cos = rng.uniform(0.3, 1.0, size=R).astype(np.float32)
    bias = rng.normal(size=(R, 1)).astype(np.float32) * 0.05
    args = (0.3, 40.0, 1.0, 1e4)
    for b in (0.0, bias):
        jl, jd = jlosses.sdf_losses(*map(jnp.asarray, (z, sdf, valid, ray_mask, gt, cos)), *args,
                                    sdf_bias=b)
        tl, td = tlosses.sdf_losses(*map(torch.as_tensor, (z, sdf, valid, ray_mask, gt, cos)),
                                    *args, sdf_bias=torch.as_tensor(b))
        for k in ("fs_loss", "sdf_loss", "loss"):
            _close(td[k], jd[k])


def test_sample_ray_indices_with_fed_noise():
    key = jax.random.key(7)
    valid = np.random.default_rng(5).uniform(size=500) > 0.3
    idx, pv = jsampling.sample_ray_indices(key, jnp.asarray(valid), 64)
    noise = np.asarray(jax.random.gumbel(key, valid.shape, jnp.float32))
    tidx, tpv = tsampling.sample_ray_indices(torch.as_tensor(valid), 64,
                                             noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(to_numpy(tidx), np.asarray(idx))
    np.testing.assert_array_equal(to_numpy(tpv), np.asarray(pv))
    g = torch.Generator().manual_seed(0)
    own, own_valid = tsampling.sample_ray_indices(torch.as_tensor(valid), 64, g)
    assert len(set(own.tolist())) == 64 and bool(own_valid.all())
