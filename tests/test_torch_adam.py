"""Port parity for the Adam tracker (nerfloam_tpu/core/tracking.py:383-497)
on the CPU. Tolerances:
- one iteration's loss 1e-5 relative and pose gradient 1e-4 of its
  largest entry, on the same rays, jitter and band jitter (the slice-1
  BA test's bounds: sdf_weight 1e4 amplifies rounding);
- the Adam update against optax.scale_by_adam on fixed gradient
  sequences of 400 steps: bit for bit, update and moments. The port forms
  each moment in optax's order without a fused multiply-add, the bias
  corrections 1 - b^t as optax does in float32 (its power rounded once),
  divides by them as tensors (a Python divisor is a reciprocal multiply
  on CUDA) and takes a correctly rounded sqrt (torch's vectorised CPU
  sqrt is an ulp off on ~0.7% of inputs, which was the last residual);
- the total-miss fallback: the initial pose exactly, on both sides;
- a 10-frame Adam slice on both sides: ATE under 0.30 m each (the bound
  of test_pipeline.py::test_trajectory_accuracy) and within 0.20 m of
  each other. The random streams differ (threefry vs Philox), and Adam at
  this budget (learning rate 0.01: after the second frame at most
  8 x 0.0033 m of correction per frame) keeps most of its first tracked
  frame's error, which moves by more than 0.1 m with the stream on either
  side, so the GN slices' 0.10 m would test the draw, not the port;
- the kitti_adam25 JSON equals the JAX package's config of the same
  overrides, and selects the Adam tracker.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nerfloam_tpu.core import losses as jlosses
from nerfloam_tpu.core import render as jrender
from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.core.pipeline import NerfLoamSLAM
from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import raycast as jrc
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.map import voxel_map as tvm
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_config_from_jax,
    map_state_from_numpy,
    to_numpy,
)
from nerfloam_tpu_torch.utils.config import finalize, load_json_config
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
T_RC = trc.RaycastConfig(**RC._asdict())
T_CFG = map_config_from_jax(MAP_CFG)
TRUNC, N_BAND = 0.5, 8
TP = ttr.TrackParams(n_rays=192, num_iterations=3, truncation=TRUNC, max_depth=MAX_DEPTH,
                     fs_weight=1.0, sdf_weight=1e4, surface_anchor=1, band_samples=N_BAND)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_adam_iteration_loss_and_pose_gradient_match_jax(scene):
    _, frames = scene
    m = build_map(frames)
    rng = np.random.default_rng(7)
    emb = rng.normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    params, meta = init_decoder(jax.random.key(5))
    pts, cos, T = frames[2]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::9][:192]
    p, c = p[idx], c[idx]
    R = len(idx)
    dirs = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    init6 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    t_cap = jtr.t_cap_for(p, c, TRUNC, MAX_DEPTH)
    rvalid = jnp.asarray(rng.uniform(size=R) > 0.05)
    u = rng.uniform(1e-4, 1 - 1e-4, size=(R, RC.n_samples)).astype(np.float32)
    band_u = rng.uniform(size=(R, N_BAND)).astype(np.float32)
    sdf_bias = np.asarray([0.021, -0.013], np.float32)
    bias_ray = jnp.where(c < 0.999, sdf_bias[0], sdf_bias[1])
    d0 = jse3.rotate_dirs(init6, dirs)
    occ = jrc.march_occupancy(m, MAP_CFG, RC, jnp.broadcast_to(init6[:3], d0.shape), d0, t_cap)
    pose = init6 + jnp.asarray([0.03, -0.02, 0.01, 0.002, -0.001, 0.004], jnp.float32)

    # JAX: tracking.py:435-470 (loss_fn, fixed rays) with u and the band jitter given
    def j_loss(pose6):
        wdirs = jse3.rotate_dirs(pose6, dirs)
        origin = jnp.broadcast_to(jse3.pose_translation(pose6), wdirs.shape)
        out = jrender.render_rays(m, MAP_CFG, RC, params, meta, origin, wdirs, t_cap, rvalid,
                                  None, occupancy=occ, jitter_u=jnp.asarray(u))
        ez, esdf, eval_ = jrender.extra_surface_columns(
            m, MAP_CFG, params, meta, origin, wdirs, jnp.linalg.norm(p, axis=-1), c, rvalid,
            TRUNC, 1, N_BAND, None, band_u=jnp.asarray(band_u))
        cat = lambda a, b: jnp.concatenate([a, b], axis=1)  # noqa: E731
        loss, _ = jlosses.sdf_losses(cat(out.z_vals, ez), cat(out.sdf, esdf),
                                     cat(out.valid_mask, eval_), out.ray_mask, p, c, TRUNC,
                                     MAX_DEPTH, TP.fs_weight, TP.sdf_weight,
                                     sdf_bias=bias_ray[:, None])
        return loss, jnp.sum(out.ray_mask)

    (jl, jhits), jg = jax.value_and_grad(j_loss, has_aux=True)(pose)

    tm = map_state_from_numpy(jax.device_get(m), device="cpu")
    tparams = decoder_params_from_jax(jax.device_get(params), device="cpu")
    tpose = _t(pose).requires_grad_(True)
    placer = trc.CdfPlacer(tm, T_CFG, T_RC, _t(occ[0]), _t(occ[1]), _t(t_cap), RC.n_samples)
    tl, tout = ttr.adam_loss(trender.ActiveField(tm, T_CFG), TP, tparams, tpose, _t(dirs), _t(p),
                             ieee.norm3(_t(p)), _t(c), _t(rvalid), placer, _t(u), _t(band_u),
                             _t(bias_ray))
    (tg,) = torch.autograd.grad(tl, tpose)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert int(tout.ray_mask.sum()) == int(jhits) > 100
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    assert np.abs(to_numpy(tg) - jg).max() <= 1e-4 * np.abs(jg).max()


def test_adam_update_matches_optax():
    """400 steps of scale_by_adam_ against optax.scale_by_adam() on the same
    gradients, for two sequences (six entries spread over 1e-4..10 and
    over 1e-8..1e3): update, mu and nu bit-equal at every step."""
    rng = np.random.default_rng(8)
    for decades in ((-4, 1), (-8, 3)):
        grads = rng.normal(size=(400, 6)).astype(np.float32) * np.logspace(*decades, 6,
                                                                           dtype=np.float32)
        opt = optax.scale_by_adam()
        state = opt.init(jnp.zeros(6, jnp.float32))
        mu, nu = torch.zeros(6), torch.zeros(6)
        for t, g in enumerate(grads, start=1):
            jupd, state = opt.update(jnp.asarray(g), state)
            tupd = ttr.scale_by_adam_(torch.as_tensor(g), mu, nu, t)
            msg = f"gradients over 1e{decades[0]}..1e{decades[1]}, step {t}"
            np.testing.assert_array_equal(tupd.numpy(), np.asarray(jupd), err_msg=msg)
            np.testing.assert_array_equal(mu.numpy(), np.asarray(state.mu), err_msg=msg)
            np.testing.assert_array_equal(nu.numpy(), np.asarray(state.nu), err_msg=msg)


def test_adam_total_miss_keeps_the_initial_pose(scene):
    """tracking.py:494-496: no ray hits the map at the last iteration (an
    empty active set) -> the constant-velocity init, on both sides."""
    _, frames = scene
    pts, cos, T = frames[0]
    p, c, v = pad_frame(pts, cos)
    init6 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    jm = jvm.recenter(jvm.create(MAP_CFG), MAP_CFG, jnp.zeros(3, jnp.float32))
    params, meta = init_decoder(jax.random.key(6))
    jtp = jtr.TrackParams(**TP._asdict())
    jres = jtr.track_frame(jm, MAP_CFG, RC, jtp, params, meta, init6, p, c, v,
                           jnp.asarray(0.05, jnp.float32), jax.random.key(0))
    tm = tvm.recenter(tvm.create(T_CFG, "cpu"), T_CFG, torch.zeros(3))
    tres = ttr.track_frame(tm, T_CFG, T_RC, TP, decoder_params_from_jax(jax.device_get(params),
                                                                        "cpu"),
                           _t(init6), _t(p), _t(c), _t(v), 0.05, torch.Generator().manual_seed(0))
    assert int(jres.hit_count) == 0 and int(tres.hit_count) == 0
    np.testing.assert_array_equal(np.asarray(jres.pose), np.asarray(init6))
    np.testing.assert_array_equal(to_numpy(tres.pose), np.asarray(init6))


SLICE = CANON + [
    "data_specs.n_frames=10",
    "tpu_specs.bootstrap_steps=6",
    "tpu_specs.sampler=hits",
    "tpu_specs.track_method=adam",
    "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=false",
]


@pytest.fixture(scope="module")
def adam_runs():
    cfg = load_config(CFG_PATH, SLICE)
    ds = get_dataset(cfg)
    gt = ds.gt_trajectory()
    jax_poses = np.asarray(NerfLoamSLAM(cfg, ds).run())
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    port_poses = np.asarray(slam.run())
    return gt, jax_poses, port_poses, slam


def test_adam_slice_matches_jax(adam_runs):
    gt, jax_poses, port_poses, slam = adam_runs
    assert slam.track_method == "adam"
    assert slam.tp.num_iterations == 8 and slam.tp_first.num_iterations == 40
    assert port_poses.shape == jax_poses.shape == (10, 4, 4)
    ate_jax = ev.ate_rmse(jax_poses, gt[:10], align=False)
    ate_port = ev.ate_rmse(port_poses, gt[:10], align=False)
    assert ate_jax < 0.30, ate_jax
    assert ate_port < 0.30, ate_port
    assert abs(ate_port - ate_jax) <= 0.20, (ate_port, ate_jax)
    assert slam.dropped_delta_events == 0
    assert all(hit > 0.5 for _, hit, *_ in slam.state.frame_telemetry)


def test_kitti_adam25_json_matches_jax_config():
    sys.path.insert(0, ROOT)
    import bench

    # bench.ADAM25_OVERRIDES sets tracker_specs.track_method, which the
    # pipeline does not read (it reads tpu_specs.track_method): the JSON
    # adds the tpu_specs switch so the row really runs Adam
    ref = load_config(CFG_PATH, bench.BENCH_OVERRIDES + bench.ADAM25_OVERRIDES
                      + ["tpu_specs.track_method=adam", "data_specs.n_frames=30",
                         "tpu_specs.defer_sync=false"])
    cfg = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs",
                                        "kitti_adam25.json"))
    assert cfg.as_dict() == ref.as_dict()
    slam = NerfLoamSLAM_torch(cfg, None, device="cpu")
    assert slam.track_method == "adam" and slam.rc_map.sampler == "hits"
    assert slam.tp.num_iterations == 25 and slam.tp_first.num_iterations == 125
    assert slam.tp.n_rays == 2048 and slam.rc_track.n_samples == 64
    assert slam.track_lr == 0.06
    assert load_config(CFG_PATH, bench.BENCH_OVERRIDES
                       + bench.ADAM25_OVERRIDES).tpu_specs["track_method"] == "gn"
