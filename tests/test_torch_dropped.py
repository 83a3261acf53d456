"""Port parity: the knobs the JAX package measured and dropped, now in the
port, and ``do_mapping(selection_method="previous")``.

- ``tpu_specs.maturity_warmup`` (K3's maturity form; its plain twins on the
  CPU): the GN tracker, grid and hits samplers, on
  ``__graft_entry__._build_tiny_problem(n_rays=256)`` with a seeded packed
  table and mixed per-row BA-touch counts, against JAX's
  ``track_frame_gn``, both fed the same numpy draws (threefry and Philox
  differ): equal hit counts and the pose within 2e-4, the tolerance of the
  port's GN tracker parity under dp (tests/test_torch_sharding.py); the
  knob moves the pose on both sides; the dp form's sums combine to the
  one-launch form's system under the weights.
- ``tpu_specs.bias_source=keyframe``: ``ba.surface_bias_at`` against JAX's
  on the same map, decoder, pose and points: counts equal, means within
  1e-6 relative.
- ``tpu_specs.bias_classes=2``: the per-class EMA of the probe bit-equal
  to JAX's ``_update_sdf_bias``, over probes with an empty and a NaN class.
- the invalid combinations raise JAX's ``ValueError`` with its message.
- ``selection_method="previous"``: the window's frame ids equal JAX's, and
  one BA step over it (``bp_random``) within the BA parity tolerances of
  tests/test_sharding.py::test_sharded_ba_step_matches_single_chip.
- a short CPU run of the port with the three knobs on.
"""

import os
from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _canon import CANON
from _torch_dp_cases import _Fed
from test_torch_sharding import _Draws, _fed_jax
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.bridge import (
    decoder_meta_from_jax,
    decoder_params_from_jax,
    map_state_from_numpy,
    to_numpy,
)
from nerfloam_tpu_torch.utils.config import finalize

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
WARMUP = 4


@pytest.fixture(scope="module")
def tiny():
    """The tiny problem with a seeded packed table and BA-touch counts 0-8."""
    import __graft_entry__ as g

    (map_cfg, rc, state, dec, meta, pose6, _r, _c, _v, frame) = g._build_tiny_problem(n_rays=256)
    rng = np.random.default_rng(11)
    C = np.asarray(state.upd_count).shape[0]
    state = state._replace(
        packed=jnp.asarray(rng.normal(0, 0.05, np.asarray(state.packed).shape).astype(np.float32)),
        upd_count=jnp.asarray(rng.integers(0, 9, C).astype(np.int32)))
    host = {"map_cfg": MapConfig(**{k: getattr(map_cfg, k) for k in MapConfig._fields
                                    if hasattr(map_cfg, k)}),
            "rc": RaycastConfig(**{k: getattr(rc, k) for k in RaycastConfig._fields
                                   if hasattr(rc, k)}),
            "state": map_state_from_numpy(jax.device_get(state), device="cpu"),
            "dec": decoder_params_from_jax(jax.device_get(dec), device="cpu")}
    return (map_cfg, rc, state, dec, meta, pose6, frame), host


def _jax_track(tiny, sampler, warmup, draws):
    from nerfloam_tpu.core import tracking as jtr

    (map_cfg, rc, state, dec, meta, pose6, (fpts, fcos, fval)), _ = tiny
    tp = jtr.TrackParams(n_rays=256, num_iterations=4, truncation=0.3, max_depth=rc.max_depth,
                         fs_weight=1.0, sdf_weight=1000.0, maturity_warmup=warmup)
    init = pose6 + jnp.asarray([0.05, -0.04, 0.02, 0, 0, 0.01], jnp.float32)
    jax.clear_caches()
    with ExitStack() as stack:
        _fed_jax(stack, draws)
        out = jtr.track_frame_gn(state, map_cfg, rc._replace(sampler=sampler), tp, dec, meta,
                                 init, fpts, fcos, fval, jnp.asarray(0.01, jnp.float32),
                                 jax.random.key(9))
        out = jax.device_get(out)
    jax.clear_caches()
    return out, np.asarray(init)


def _port_track(tiny, sampler, warmup, draws, init):
    (_, _, _, _, _, _, (fpts, fcos, fval)), h = tiny
    tp = ttr.TrackParams(n_rays=256, num_iterations=4, truncation=0.3, max_depth=h["rc"].max_depth,
                         fs_weight=1.0, sdf_weight=1000.0, maturity_warmup=warmup)
    (u,) = [v for (k, _), v in draws.made.items() if k == "uniform"]
    (gum,) = [v for (k, _), v in draws.made.items() if k == "gumbel"]
    t = lambda a: torch.as_tensor(np.array(a))
    with _Fed(gumbel=gum, uniform=u):
        return ttr.track_frame_gn(h["state"], h["map_cfg"], h["rc"]._replace(sampler=sampler), tp,
                                  h["dec"], t(init), t(fpts), t(fcos), t(fval), torch.Generator())


@pytest.mark.parametrize("sampler", ["grid", "hits"])
def test_maturity_tracker_matches_jax(tiny, sampler):
    """The GN tracker with maturity_warmup=4 against JAX's on the same
    draws: equal hit counts, the pose within 2e-4; and with the knob off
    each side's pose moves (the weights act)."""
    poses = {}
    for warmup in (WARMUP, 0):
        draws = _Draws(50 + len(sampler))
        ref, init = _jax_track(tiny, sampler, warmup, draws)
        got = _port_track(tiny, sampler, warmup, draws, init)
        assert int(got.hit_count) == int(ref.hit_count) > 0
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=2e-4)
        poses[warmup] = (got.pose.numpy(), np.asarray(ref.pose))
    for side in (0, 1):
        assert np.abs(poses[WARMUP][side] - poses[0][side]).max() > 1e-6, side


def test_maturity_weights_and_sums():
    """maturity_weights as JAX forms them (floor + (1 - floor) min(cnt /
    warmup, 1), aid clamped at 0), and K3's dp form's sums under the
    weights combine to the one-launch twin's system; the counts stay
    unweighted."""
    from nerfloam_tpu.core import tracking as jtr

    rng = np.random.default_rng(3)
    N, M, A = 48, 10, 37
    tp = ttr.TrackParams(n_rays=N, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1000.0, maturity_warmup=3, maturity_floor=0.2)
    cnt = torch.as_tensor(rng.integers(0, 7, A).astype(np.float32))
    aid = torch.as_tensor(rng.integers(-1, A, (N, M)).astype(np.int32))
    w = ttr.maturity_weights(cnt, aid, tp)
    jt = jtr.TrackParams(n_rays=N, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1000.0, maturity_warmup=3, maturity_floor=0.2)
    jc = jnp.asarray(cnt.numpy())[jnp.clip(jnp.asarray(aid.numpy()), 0)]
    jw = jt.maturity_floor + (1.0 - jt.maturity_floor) * jnp.minimum(jc / float(3), 1.0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    xyz, g = t(rng.normal(size=(N, M, 3)) * 5), t(rng.normal(size=(N, M, 3)))
    args = (xyz, t([0.1, -0.2, 0.3]), t(rng.uniform(0.5, 20, (N, M))),
            t(rng.normal(size=(N, M)) * 0.3), g, torch.as_tensor(rng.uniform(size=(N, M)) > 0.2),
            t(rng.uniform(0.5, 1.0, N)), t(rng.uniform(1, 20, N)),
            torch.as_tensor(rng.uniform(size=N) > 0.1), tp, t(rng.normal(size=N) * 0.02))
    H, b, loss = ttr.gn_system_plain(*args, w)
    sums = ttr.gn_sums_plain(*args, w)
    plain_sums = ttr.gn_sums_plain(*args)
    np.testing.assert_array_equal(sums[-2:].numpy(), plain_sums[-2:].numpy())
    H2, b2, loss2 = ttr.gn_combine(sums, tp)
    for got, ref in ((H2, H), (b2, b), (loss2, loss)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))
    H0, _, _ = ttr.gn_system_plain(*args)
    assert not torch.equal(H0, H)
    # the tracker's object: the maturity form on the CPU is the weighted twin
    system = ttr.GnSystem(*args[6:9], args[10], tp, M, cnt=cnt)
    sH, sb, sl = system(*args[:6], aid)
    assert torch.equal(sH, H) and torch.equal(sb, b) and torch.equal(sl, loss)
    with pytest.raises(ValueError, match="aid"):
        system(*args[:6])


def test_surface_bias_at_matches_jax(tiny):
    """The keyframe probe: the (2, 2) [means; counts] at the frame's points
    under its pose, on a trained-looking field: counts equal, means within
    1e-6 relative of JAX's."""
    from nerfloam_tpu.core import ba as jba

    (map_cfg, rc, state, dec, meta, pose6, (fpts, fcos, fval)), h = tiny
    ref = np.asarray(jba.surface_bias_at(state, map_cfg, dec, meta, pose6, fpts, fval,
                                         rc.max_depth, points_cos=fcos))
    t = lambda a: torch.as_tensor(np.array(a))
    got = tba.surface_bias_at(h["state"], h["map_cfg"], h["dec"], decoder_meta_from_jax(meta),
                              t(pose6), t(fpts), t(fval), rc.max_depth, points_cos=t(fcos)).numpy()
    assert ref[1].min() > 0, ref  # both classes are sampled
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    ref1 = np.asarray(jba.surface_bias_at(state, map_cfg, dec, meta, pose6, fpts, fval,
                                          rc.max_depth))
    got1 = tba.surface_bias_at(h["state"], h["map_cfg"], h["dec"], decoder_meta_from_jax(meta),
                               t(pose6), t(fpts), t(fval), rc.max_depth).numpy()
    np.testing.assert_array_equal(got1[1], ref1[1])
    np.testing.assert_allclose(got1[0], ref1[0], rtol=1e-6)


class _Ema:
    """The attributes ``_update_sdf_bias`` reads, for either package."""

    def __init__(self, classes, pooled):
        self.bias_correction, self.bias_classes = True, classes
        self.sdf_bias = np.zeros(2, np.float32)
        self._pooled_bias = pooled


@pytest.mark.parametrize("classes", [1, 2])
def test_bias_ema_bit_equal(classes):
    """The EMA of the (2, 2) probe, per class (2) or pooled (1), bit-equal
    to JAX's over probes with an empty class, a NaN mean and a scalar."""
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM

    probes = [np.array([[0.02, -0.01], [30.0, 70.0]], np.float32),
              np.array([[0.05, 0.0], [12.0, 0.0]], np.float32),
              np.array([[np.nan, 0.03], [0.0, 5.0]], np.float32),
              np.float32(0.013),
              np.array([[-0.004, 0.017], [9.0, 4.0]], np.float32)]
    j, p = _Ema(classes, NerfLoamSLAM._pooled_bias), _Ema(classes, NerfLoamSLAM_torch._pooled_bias)
    for probe in probes:
        NerfLoamSLAM._update_sdf_bias(j, probe)
        NerfLoamSLAM_torch._update_sdf_bias(p, probe)
        assert p.sdf_bias.dtype == j.sdf_bias.dtype
        np.testing.assert_array_equal(p.sdf_bias.view(np.uint32), j.sdf_bias.view(np.uint32))
    assert classes == 1 or p.sdf_bias[0] != p.sdf_bias[1]


@pytest.mark.parametrize("knobs", [["tpu_specs.bias_source=settled"],
                                   ["tpu_specs.bias_classes=2"],
                                   ["tpu_specs.bias_classes=2", "tpu_specs.bias_source=window"]])
def test_invalid_bias_knobs_raise_as_jax(knobs):
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM

    cfg = load_config(CFG_PATH, CANON + knobs)
    with pytest.raises(ValueError) as ref:
        NerfLoamSLAM(cfg, None)
    with pytest.raises(ValueError) as got:
        NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")
    assert str(got.value) == str(ref.value)


# small scans and ray counts, as __graft_entry__.dryrun_multichip's frame path
SMALL = ["data_specs.n_beams=16", "data_specs.n_azimuth=256", "tpu_specs.points_pad=4096",
         "tpu_specs.kf_points_pad=4096", "tracker_specs.N_rays=256",
         "mapper_specs.N_rays_each=256"]
PREV = CANON + SMALL + ["data_specs.n_frames=6", "mapper_specs.window_size=3",
                        "tpu_specs.ba_ray_superset=2"]


def test_previous_window_matches_jax():
    """``selection_method="previous"`` on five keyframes: the last three
    (window_size) on both sides, and one BA step over them (bp_random,
    poses free but the first frame's) within the BA parity tolerances."""
    from nerfloam_tpu.core.frame import Frame as JFrame
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM
    from nerfloam_tpu.data import get_dataset as jget_dataset
    from nerfloam_tpu_torch.core.frame import Frame

    cfg = load_config(CFG_PATH, PREV)
    ds = jget_dataset(cfg)
    js = NerfLoamSLAM(cfg, ds)
    ps = NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")
    for i in range(5):
        idx, pts, cos, pose = ds[i]
        for s, F in ((js, JFrame), (ps, Frame)):
            f = F.from_raw(idx, pts, cos, pose, s.points_pad, has_gt_pose=True)
            if i < 3:
                if i == 0:
                    s._recenter(f.pose6[:3], refresh=False)
                s.create_voxels(f)
            s.insert_keyframe(f)
    js.state.map_state = jvm.refresh_active(js.state.map_state, js.map_cfg)
    ps.state.map_state = map_state_from_numpy(jax.device_get(js.state.map_state), device="cpu")
    ps.state.decoder_params = decoder_params_from_jax(jax.device_get(js.state.decoder_params),
                                                      device="cpu")
    ids = [f.index for f in js._select_previous_window()]
    assert ids == [f.index for f in ps._select_previous_window()] == [2, 3, 4]
    draws = _Draws(77)
    jax.clear_caches()
    with ExitStack() as stack:
        _fed_jax(stack, draws)
        ref, _ = js.do_mapping(None, selection_method="previous")
        ref = jax.device_get(ref)
    jax.clear_caches()
    made = {k: v for (k, _), v in draws.made.items()}
    # JAX's traced body draws one (P,) gumbel row for the window's frames:
    # the port draws (W, P), that row for each frame
    with _Fed(gumbel=np.tile(made["gumbel"], (3, 1)), uniform=made["uniform"],
              randint=made.get("randint")):
        got = ps.do_mapping(None, selection_method="previous")
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-2)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-3)
    diff = np.abs(to_numpy(got.embeddings) - np.asarray(ref.embeddings, np.float32))
    assert float(diff.mean()) < 5e-4, diff.mean()
    assert float((diff > 1e-2).mean()) < 0.01, (diff > 1e-2).mean()
    assert abs(int(got.touched_count) - int(ref.touched_count)) <= 2
    moved = [f.index for f in ps.state.keyframes if not np.array_equal(
        f.pose6, np.asarray(js.state.keyframes[f.index].pose6))]
    assert all(i in ids for i in moved)


def test_dropped_knobs_run_on_the_cpu():
    """Three frames of the port with maturity_warmup, the keyframe probe and
    two bias classes: finite poses, a per-class bias target, and the GN
    tracker's K3 in its maturity form (its plain twin on the CPU) on every
    GN iteration."""
    from nerfloam_tpu_torch.data import get_dataset

    cfg = load_config(CFG_PATH, CANON + SMALL + [
        "data_specs.n_frames=3", "tpu_specs.bootstrap_steps=3", "tpu_specs.defer_sync=false",
        "tpu_specs.maturity_warmup=4", "tpu_specs.bias_correction=true",
        "tpu_specs.bias_source=keyframe", "tpu_specs.bias_classes=2"])
    c = finalize(cfg.as_dict())
    slam = NerfLoamSLAM_torch(c, get_dataset(c), device="cpu")
    assert slam.tp.maturity_warmup == 4 and not slam.bp_current.measure_bias
    calls = []
    real = ttr.GnSystem._call_maturity

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    ttr.GnSystem._call_maturity = spy
    try:
        poses = np.asarray(slam.run())
    finally:
        ttr.GnSystem._call_maturity = real
    assert poses.shape == (3, 4, 4) and np.isfinite(poses).all()
    assert len(calls) == slam.tp_first.num_iterations + slam.tp.num_iterations
    assert np.isfinite(slam.sdf_bias).all() and slam.sdf_bias[0] != slam.sdf_bias[1]
    probe = [t[3] for t in slam.state.frame_telemetry]
    assert all(np.isfinite(probe))
