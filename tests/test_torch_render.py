"""Port parity: core/render.render_rays_hits (K1/K2 through their plain
twins on the CPU) against the JAX package, and one BA loss's gradients with
respect to the packed table, the decoder and the pose against jax.grad of
render_rays_hits + sdf_losses. sdf to 1e-5; gradients to 1e-4 relative to
each gradient's largest entry (sdf_weight 1e4 amplifies rounding)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfloam_tpu.core import losses as jlosses
from nerfloam_tpu.core import render as jrender
from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import raycast as jrc
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import losses as tlosses
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.utils.bridge import decoder_params_from_jax, hit_table_from_numpy, to_numpy
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

torch.set_num_threads(2)
RCH = RC._replace(sampler="hits", max_hits=20)
TRUNC, FS_W, SDF_W = 0.5, 1.0, 1e4


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def setup(scene):
    _, frames = scene
    m = build_map(frames)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    params, meta = init_decoder(jax.random.key(0))
    pts, cos, T = frames[1]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::9][:192]
    p, c = p[idx], c[idx]
    dirs = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    pose6 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    d = jse3.rotate_dirs(pose6, dirs)
    o = jnp.broadcast_to(jse3.pose_translation(pose6), d.shape)
    ht = jrc.build_hit_table(m, MAP_CFG, RCH, o, d, jtr.t_cap_for(p, c, TRUNC, MAX_DEPTH))
    ray_valid = jnp.asarray(rng.uniform(size=len(idx)) > 0.05)
    u = rng.uniform(1e-4, 1 - 1e-4, size=(len(idx), RCH.n_samples)).astype(np.float32)
    # the pose the samples are rendered at: 2 cm / 0.3 deg off the table's
    pose_r = pose6 + jnp.asarray([0.02, -0.01, 0.0, 0.0, 0.0, 0.005], jnp.float32)
    return dict(m=m, params=params, meta=meta, p=p, c=c, dirs=dirs, pose=pose_r, ht=ht,
                ray_valid=ray_valid, u=u)


def _j_loss(s, packed, params, pose6):
    d = jse3.rotate_dirs(pose6, s["dirs"])
    o = jnp.broadcast_to(jse3.pose_translation(pose6), d.shape)
    out = jrender.render_rays_hits(s["m"]._replace(packed=packed), MAP_CFG, RCH, params, s["meta"],
                                   o, d, s["ht"], s["ray_valid"], None, jitter_u=jnp.asarray(s["u"]))
    loss, _ = jlosses.sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, s["p"], s["c"],
                                 TRUNC, MAX_DEPTH, FS_W, SDF_W)
    return loss, out


def _t_loss(s, packed, params, pose6):
    dirs = _t(s["dirs"])
    d = tse3.rotate_dirs(pose6, dirs)
    o = tse3.pose_translation(pose6).expand_as(d)
    out = trender.render_rays_hits(packed, params, MAP_CFG.voxel_size, o, d,
                                   hit_table_from_numpy(jax.device_get(s["ht"]), device="cpu"),
                                   _t(s["ray_valid"]), _t(s["u"]))
    loss, _ = tlosses.sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, _t(s["p"]),
                                 _t(s["c"]), TRUNC, MAX_DEPTH, FS_W, SDF_W,
                                 gt_norm=ieee.norm3(_t(s["p"])))
    return loss, out


def test_render_rays_hits_matches_jax(setup):
    s = setup
    _, jout = _j_loss(s, s["m"].packed, s["params"], s["pose"])
    _, tout = _t_loss(s, _t(s["m"].packed), decoder_params_from_jax(jax.device_get(s["params"]), "cpu"),
                      _t(s["pose"]))
    np.testing.assert_array_equal(to_numpy(tout.valid_mask), np.asarray(jout.valid_mask))
    np.testing.assert_array_equal(to_numpy(tout.ray_mask), np.asarray(jout.ray_mask))
    np.testing.assert_allclose(to_numpy(tout.z_vals), np.asarray(jout.z_vals), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(to_numpy(tout.sdf), np.asarray(jout.sdf), atol=1e-5)
    assert 0.3 < float(np.asarray(jout.valid_mask).mean()) < 1.0


def test_ba_loss_gradients_match_jax(setup):
    s = setup
    (jl, _), jg = jax.value_and_grad(lambda *a: _j_loss(s, *a), argnums=(0, 1, 2), has_aux=True)(
        s["m"].packed, s["params"], s["pose"])
    packed = _t(s["m"].packed).requires_grad_(True)
    params = decoder_params_from_jax(jax.device_get(s["params"]), device="cpu")
    flat = params["w"] + params["b"]
    for q in flat:
        q.requires_grad_(True)
    pose = _t(s["pose"]).requires_grad_(True)
    tl, _ = _t_loss(s, packed, params, pose)
    grads = torch.autograd.grad(tl, [packed, *flat, pose])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)

    jp, jd, jpose = jax.device_get(jg)
    jflat = [lay["w"] for lay in jd["layers"]] + [jd["out"]["w"]]
    jflat += [lay["b"] for lay in jd["layers"]] + [jd["out"]["b"]]
    pairs = [("packed", grads[0], jp)] + [
        (f"decoder[{i}]", g, r) for i, (g, r) in enumerate(zip(grads[1:-1], jflat))
    ] + [("pose", grads[-1], jpose)]
    for name, g, ref in pairs:
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(to_numpy(g) - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    # the rows BA marks as touched are the rows with a nonzero gradient
    np.testing.assert_array_equal(to_numpy((grads[0] != 0).any(-1)), (np.asarray(jp) != 0).any(-1))


def test_ba_step_with_kept_reconcile_scratch_matches_without(scene):
    """One BA step on the hit table (its superset's table packed by the
    one K4 call) with a ReconcileScratch kept by the caller, as the
    pipeline keeps it, gives the BAResult of the step without one (K5 then
    makes its own), field for field; a second step through the same
    scratch gives the same again."""
    from nerfloam_tpu_torch.core import ba as tba
    from nerfloam_tpu_torch.map import voxel_map as tvm
    from nerfloam_tpu_torch.models.decoder import init_decoder as t_init_decoder
    from nerfloam_tpu_torch.ops.raycast import RaycastConfig
    from nerfloam_tpu_torch.utils.bridge import map_state_from_numpy

    _, frames = scene
    tm = map_state_from_numpy(jax.device_get(build_map(frames)), device="cpu")
    cfg = tvm.MapConfig(capacity=MAP_CFG.capacity, grid_dim=MAP_CFG.grid_dim,
                        voxel_size=MAP_CFG.voxel_size)
    rc = RaycastConfig(**RCH._asdict())
    params = t_init_decoder(width=32, generator=torch.Generator().manual_seed(2), device="cpu")
    bp = tba.BAParams(n_frames=2, n_rays=96, num_iterations=2, truncation=TRUNC,
                      max_depth=MAX_DEPTH, fs_weight=FS_W, sdf_weight=SDF_W, touched_cap=256)
    P, C, V, poses = [], [], [], []
    for pts, cos, T in frames[:2]:
        p, c, v = pad_frame(pts, cos)
        P.append(_t(p)), C.append(_t(c)), V.append(_t(v))
        poses.append(np.asarray(jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))))
    args = (tm, cfg, rc, bp, params, _t(np.stack(poses)), torch.stack(P), torch.stack(C),
            torch.stack(V), torch.ones(2, dtype=torch.bool), torch.tensor([False, True]), True,
            [0.05, 0.005, 0.001])
    scratch = tvm.ReconcileScratch()
    runs = [tba.ba_step(*args, torch.Generator().manual_seed(3), reconcile_scratch=s)
            for s in (None, scratch, scratch)]
    for res in runs[1:]:
        for name in tba.BAResult._fields:
            a, b = getattr(runs[0], name), getattr(res, name)
            if name == "decoder_params":
                assert all(torch.equal(x, y) for k in a for x, y in zip(a[k], b[k])), name
            else:
                assert torch.equal(a, b), name
    assert int(runs[0].touched_count) > 0
