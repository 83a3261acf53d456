"""The off-by-default knobs of the port against the JAX package on the
CPU: the BA-delta telemetry, ba_pose_project=along's motion direction,
remove_back's mask, the decoder's skips and positional embedders, the
checkpoint keys they add, and a 10-frame synthetic_small run of
replay_freq beside the JAX package's (ba_pose_project=along's run:
tests/test_torch_knobs_along.py; remove_back and GT-pose mapping-only
frames: tests/test_torch_knobs_mapping.py; their own files, so that the
test runner's workers can take the three runs side by side).

Tolerances: host arithmetic (telemetry, masks, the motion direction)
exact; the decoder 1e-5 in float32 (another summation order and torch's
sin / cos against XLA's, which differ by an ulp; the gaussian embedder's
sin(x @ B) takes its argument near 100, where an ulp of the product is
~1e-5, so 1e-4 there) and one bf16 step, 2e-2, with bf16 operands (as
tests/test_torch_ops.py::test_decoder_matches_jax); the slices as
tests/test_torch_pipeline.py's: both ATEs under 0.30 m and within 0.10 m
of each other (random streams differ: threefry against Philox)."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core.frame import Frame as JFrame
from nerfloam_tpu.core.pipeline import NerfLoamSLAM
from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.models import decoder as jdec
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.frame import Frame
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.models import decoder as tdec
from nerfloam_tpu_torch.utils import checkpoint as tckpt
from nerfloam_tpu_torch.utils.bridge import (
    decoder_meta_from_jax,
    decoder_params_from_jax,
    load_jax_checkpoint,
)
from nerfloam_tpu_torch.utils.config import finalize

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
SLICE = CANON + [
    "data_specs.n_frames=10",
    "tpu_specs.bootstrap_steps=6",
    "tpu_specs.sampler=hits",
    "tpu_specs.track_method=gn",
    "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=false",
]


def _telemetry_host():
    return types.SimpleNamespace(state=types.SimpleNamespace(ba_delta_telemetry=[]))


def test_record_ba_delta_matches_jax():
    """The same tracker, BA and previous poses give the same rows, to the
    last bit (float64 on the host in both), a frame at rest included."""
    rng = np.random.default_rng(0)
    j_host, t_host = _telemetry_host(), _telemetry_host()
    for k in range(64):
        prev = rng.normal(size=6).astype(np.float32) * 10
        tracked = prev + rng.normal(size=6).astype(np.float32) * (0.0 if k == 7 else 0.5)
        refined = tracked + rng.normal(size=6).astype(np.float32) * 0.01
        args = [(cls(k, None, None, None, 0, tracked.copy()),
                 cls(k, None, None, None, 0, refined.copy())) for cls in (JFrame, Frame)]
        NerfLoamSLAM._record_ba_delta(j_host, *args[0], prev)
        NerfLoamSLAM_torch._record_ba_delta(t_host, *args[1], prev)
    rows_j, rows_t = j_host.state.ba_delta_telemetry, t_host.state.ba_delta_telemetry
    assert len(rows_t) == 64 and rows_t == rows_j
    assert rows_t[7][1:3] == (0.0, 0.0)  # at rest: no motion frame


def test_along_direction_matches_jax():
    """ba_pose_project=along's direction, computed on the device inside the
    frame: fwd = mvec / max(|mvec|, 1e-9) past 1e-6 m of motion, zero
    below, bit for bit JAX's (pipeline.py:1013-1017)."""
    rng = np.random.default_rng(1)
    for scale in (1.0, 1e-3, 1e-7, 0.0):
        cur = rng.normal(size=6).astype(np.float32)
        prev = (cur + rng.normal(size=6).astype(np.float32) * np.float32(scale)).astype(
            np.float32)
        got = NerfLoamSLAM_torch._along_dir(torch.as_tensor(cur), torch.as_tensor(prev))
        mvec = jnp.asarray(cur)[:3] - jnp.asarray(prev)[:3]
        n = jnp.linalg.norm(mvec)
        ref = jnp.where(n > 1e-6, mvec / jnp.maximum(n, 1e-9), jnp.zeros(3))[None]
        assert got.shape == (1, 3)
        assert np.array_equal(got.numpy(), np.asarray(ref)), scale


@pytest.mark.parametrize("rel", ["none", "set"])
def test_without_back_points_matches_jax(rel):
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(4096, 3)) * [12.0, 12.0, 2.0]).astype(np.float32)
    cos = rng.uniform(0.1, 1.0, 4096).astype(np.float32)
    rel_pose = None
    if rel == "set":
        rel_pose = np.eye(4)
        rel_pose[:3, 3] = [-0.3, 0.8, 0.05]
    j = JFrame.from_raw(3, pts, cos, None, 5000)
    t = Frame.from_raw(3, pts, cos, None, 5000)
    j.rel_pose = t.rel_pose = rel_pose
    jm, tm = j.without_back_points(12.0), t.without_back_points(12.0)
    assert np.array_equal(tm.valid, jm.valid) and tm.n_points == jm.n_points
    assert 0 < tm.n_points < t.n_points  # the rule dropped some points, not all
    assert np.array_equal(tm.points, t.points) and tm.rel_pose is rel_pose


DECODERS = {
    "skips": dict(skips=(0,)),
    "nerf": dict(skips=(0,), embedder="nerf", multires=4),
    "gaussian": dict(embedder="gaussian"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(DECODERS))
def test_decoder_variants_match_jax(variant, dtype):
    """decoder_apply with skips, the nerf embedder (multires 4: a first
    layer 144 wide) and the gaussian embedder, forward and the gradient
    with respect to its input (jax.grad), the JAX parameters carried over
    by decoder_params_from_jax and its meta by decoder_meta_from_jax."""
    params, meta = jdec.init_decoder(jax.random.key(3), **DECODERS[variant])
    tparams = decoder_params_from_jax(jax.device_get(params), device="cpu")
    tmeta = decoder_meta_from_jax(meta)
    assert tmeta == tdec.DecoderMeta(**{"skips": (), **DECODERS[variant]})
    assert ("gaussian_B" in tparams) == (variant == "gaussian")
    feats = np.random.default_rng(4).normal(size=(256, 16)).astype(np.float32) * 0.5
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jdec.decoder_apply(params, meta, jnp.asarray(feats), jd)
    jgrad = jax.grad(lambda f: jnp.sum(jdec.decoder_apply(params, meta, f, jd)))(
        jnp.asarray(feats))
    x = torch.as_tensor(feats).requires_grad_(True)
    got = tdec.decoder_apply(tparams, x, td, tmeta)
    (tgrad,) = torch.autograd.grad(got.sum(), x)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4 if variant == "gaussian" else 1e-5
    scale = max(1.0, float(np.abs(np.asarray(jgrad)).max()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=tol, atol=tol * scale)


def _knob_cfg(extra):
    return load_config(CFG_PATH, SLICE + extra)


def test_checkpoint_roundtrip_telemetry_and_gaussian_B(tmp_path):
    """The port writes and reads the BA-delta rows and the gaussian
    embedder's B (JAX's keys: ba_delta_telemetry, dec_gaussian_B)."""
    cfg = finalize(_knob_cfg(["decoder_specs.embedder=gaussian"]).as_dict())
    a = NerfLoamSLAM_torch(cfg, None, device="cpu")
    rows = [(3.0, 0.01, -0.002, 0.0005), (4.0, -0.003, 0.001, 0.0)]
    a.state.ba_delta_telemetry = list(rows)
    tckpt.save_checkpoint(str(tmp_path / "c"), a)
    data = np.load(str(tmp_path / "c" / "state.npz"))
    assert data["ba_delta_telemetry"].shape == (2, 4)
    assert data["dec_gaussian_B"].shape == (16, 93)
    b = NerfLoamSLAM_torch(cfg, None, device="cpu")
    tckpt.load_checkpoint(str(tmp_path / "c"), b)
    assert b.state.ba_delta_telemetry == rows
    assert torch.equal(b.state.decoder_params["gaussian_B"], a.state.decoder_params["gaussian_B"])
    for k in ("w", "b"):
        assert all(torch.equal(x, y) for x, y in zip(a.state.decoder_params[k],
                                                      b.state.decoder_params[k]))


def test_jax_checkpoint_with_telemetry_and_gaussian_B_loads(tmp_path):
    from nerfloam_tpu.utils.checkpoint import save_checkpoint as j_save

    cfg = _knob_cfg(["decoder_specs.embedder=gaussian"])
    js = NerfLoamSLAM(cfg, None)
    js.state.ba_delta_telemetry = [(5, 0.0123, -0.0004, 0.0007), (6, -0.002, 0.0031, -0.0001)]
    j_save(str(tmp_path / "jax"), js)
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")
    load_jax_checkpoint(str(tmp_path / "jax"), slam)
    assert slam.state.ba_delta_telemetry == [tuple(float(v) for v in r)
                                             for r in js.state.ba_delta_telemetry]
    B = np.asarray(js.state.decoder_params["gaussian_B"])
    assert np.array_equal(slam.state.decoder_params["gaussian_B"].numpy(), B)


def _runs(extra, hook=None):
    """10 frames through both packages: (gt, JAX poses, port poses, JAX
    slam, port slam); ``hook(slam)`` is called on each before its run."""
    cfg = _knob_cfg(extra)
    ds = get_dataset(cfg)
    js = NerfLoamSLAM(cfg, ds)
    ts = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    if hook is not None:
        hook(js)
        hook(ts)
    jp = np.asarray(js.run())
    tp = np.asarray(ts.run())
    return ds.gt_trajectory()[:10], jp, tp, js, ts


def _ates(gt, jp, tp):
    assert tp.shape == jp.shape == (10, 4, 4)
    ate_j = ev.ate_rmse(jp, gt, align=False)
    ate_t = ev.ate_rmse(tp, gt, align=False)
    assert ate_j < 0.30, ate_j
    assert ate_t < 0.30, ate_t
    assert abs(ate_t - ate_j) <= 0.10, (ate_t, ate_j)
    return ate_j, ate_t


def _record_windows(slam):
    """Wrap the random-window draw to record each window's keyframe ids."""
    slam.windows = []
    pick = slam._select_random_window

    def recorded():
        out = pick()
        slam.windows.append([kf.index for kf in out])
        return out

    slam._select_random_window = recorded


def test_replay_freq_slice_matches_jax():
    """replay_freq=3 with a keyframe every other frame (keyframe_gap 0.7 m
    at 0.4 m a frame): both packages replay after the same frames, over
    the same keyframe windows (both draw them from Python's random with
    the config's seed), and finalize's replay too."""
    gt, jp, tp, js, ts = _runs(["tpu_specs.replay_freq=3", "mapper_specs.keyframe_gap=0.7"],
                               _record_windows)
    _ates(gt, jp, tp)
    kj = [f.index for f in js.state.keyframes]
    assert [f.index for f in ts.state.keyframes] == kj and len(kj) > 4
    assert ts.windows == js.windows
    assert len(ts.windows) >= 3 + len(kj) + 1  # the schedule's replays, then finalize's
    assert any(len(w) == 4 and w != kj[:4] for w in ts.windows)  # an anchored window
    assert ts.prof.summary()["replay"]["count"] >= 2
    assert ts.dropped_delta_events == 0
