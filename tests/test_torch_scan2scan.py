"""The port's scan-to-scan term against the JAX package on the CPU:
`build_prev_scan` (K11a's plain twin) and `s2s_system` (K11b's) on the
corridor scans of tests/test_scan2scan.py, the port's versions of that
file's three geometry tests, and an 8-frame pipeline slice with
`s2s_weight=10`.

Tolerances: pixel bins are `int()` of `atan2` results, and XLA's CPU atan2
may differ from torch's by an ulp, so at most 0.1% of the pixels may differ
in validity, and points and normals are compared on the other pixels: q_w
to 1e-5 m, n_w to 1e-4 (a unit normal from differences of nearby points
amplifies the last bit of its inputs). H, b and loss to rtol 1e-4 of their
largest entry (another summation order). The pipeline slice: both runs keep
every pose within 1.0 m of ground truth, as the JAX test asks, and within
0.10 m of each other in ATE (the random streams differ)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core import scan2scan as js2s
from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core import scan2scan as ts2s
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.utils.bridge import prev_scan_from_numpy, to_numpy
from nerfloam_tpu_torch.utils.config import finalize, load_json_config

from _canon import CANON
from test_scan2scan import SP as JSP, corridor_scan, world_scan_at

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
SP = ts2s.Scan2ScanParams(**JSP._asdict())


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _prev(pts, pose6, valid=None):
    valid = np.ones(len(pts), bool) if valid is None else valid
    return ts2s.build_prev_scan(SP, _t(pts), _t(valid), _t(pose6, torch.float32))


@pytest.mark.parametrize("pose6", [np.zeros(6, np.float32),
                                   np.array([3.0, -1.0, 0.5, 0.02, -0.01, 0.3], np.float32)])
def test_build_prev_scan_matches_jax(pose6):
    rng = np.random.default_rng(0)
    pts = corridor_scan(rng)
    pad = np.zeros((256, 3), np.float32)                      # padding rows, as in a Frame
    pts = np.concatenate([pts, pad])
    valid = np.concatenate([rng.uniform(size=len(pts) - 256) > 0.03, np.zeros(256, bool)])
    jp = jax.device_get(js2s.build_prev_scan(JSP, jnp.asarray(pts), jnp.asarray(valid),
                                             jnp.asarray(pose6)))
    tp = to_numpy(ts2s.build_prev_scan(SP, _t(pts), _t(valid), _t(pose6)))
    assert tp.q_w.shape == jp.q_w.shape == (SP.n_elev, SP.n_az, 3)
    np.testing.assert_allclose(tp.elev_min, jp.elev_min, atol=1e-6)
    np.testing.assert_allclose(tp.elev_max, jp.elev_max, atol=1e-6)
    assert jp.pix_valid.sum() > 500
    # pixel assignment: a border point in a neighbouring bin moves two
    # pixels' means; at most 0.1% of the pixels may differ
    same_q = np.abs(tp.q_w - jp.q_w).max(-1) <= 1e-5
    assert (~same_q).mean() <= 1e-3, (~same_q).mean()
    assert (tp.pix_valid != jp.pix_valid).mean() <= 1e-3
    same_d = np.abs(tp.depth - jp.depth) <= 1e-5
    assert (~same_d).mean() <= 1e-3
    # normals where both are valid and the pixel's neighbourhood agrees
    nb = same_q & np.roll(same_q, 1, 1) & np.roll(same_q, -1, 1)
    nb[1:] &= same_q[:-1]
    nb[:-1] &= same_q[1:]
    m = nb & tp.pix_valid & jp.pix_valid
    assert m.sum() > 500
    assert np.abs(tp.n_w - jp.n_w)[m].max() <= 1e-4


def test_s2s_system_matches_jax():
    pts_prev = corridor_scan(np.random.default_rng(1))
    pose_prev = np.array([0.2, 0.1, 0.0, 0.0, 0.0, 0.05], np.float32)
    jprev = js2s.build_prev_scan(JSP, jnp.asarray(pts_prev), jnp.ones(len(pts_prev), dtype=bool),
                                 jnp.asarray(pose_prev))
    tprev = prev_scan_from_numpy(jax.device_get(jprev), device="cpu")
    pose_cur = np.array([1.2, 0.15, 0.02, 0.0, 0.01, 0.06], np.float32)
    rng = np.random.default_rng(2)
    pts_cur = world_scan_at(corridor_scan(rng), pose_cur)[:2048]
    rv = rng.uniform(size=len(pts_cur)) > 0.05
    sp10, jsp10 = SP._replace(weight=10.0), JSP._replace(weight=10.0)
    jH, jb, jl = js2s.s2s_system(jsp10, jprev, jnp.asarray(pose_cur), jnp.asarray(pts_cur),
                                 jnp.asarray(rv))
    tH, tb, tl = ts2s.s2s_system(sp10, tprev, _t(pose_cur), _t(pts_cur), _t(rv))
    assert float(jnp.trace(jH[:3, :3])) > 1000
    for name, t, j in (("H", tH, jH), ("b", tb, jb), ("loss", tl, jl)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)


def test_range_image_normals():
    pts = corridor_scan(np.random.default_rng(0))
    prev = to_numpy(_prev(pts, np.zeros(6, np.float32)))
    n, v, q = prev.n_w.reshape(-1, 3), prev.pix_valid.reshape(-1), prev.q_w.reshape(-1, 3)
    assert v.sum() > 500
    floor = v & (q[:, 2] < -1.5) & (np.abs(q[:, 1]) < 4.0)
    assert floor.sum() > 100
    assert (n[floor, 2] > 0.9).mean() > 0.8, "floor normals not up"
    wall = v & (np.abs(q[:, 1]) > 5.5) & (q[:, 2] > -1.0)
    if wall.sum() > 50:
        assert (np.abs(n[wall, 1]) > 0.9).mean() > 0.7


def test_residuals_zero_at_true_pose():
    prev = _prev(corridor_scan(np.random.default_rng(1)), np.zeros(6, np.float32))
    pose_cur = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    pts_cur = _t(world_scan_at(corridor_scan(np.random.default_rng(2)), pose_cur))
    rv = torch.ones(len(pts_cur), dtype=torch.bool)
    H, b, loss = ts2s.s2s_system(SP, prev, _t(pose_cur), pts_cur, rv)
    w_sum = float(torch.trace(H[:3, :3]))
    assert w_sum > 100
    rms = (float(loss) / w_sum) ** 0.5
    assert rms < 0.1, rms
    off = np.array([0.0, 0.3, 0.0, 0.0, 0.0, 0.0], np.float32)
    H2, _, loss2 = ts2s.s2s_system(SP, prev, _t(pose_cur + off), pts_cur, rv)
    rms2 = (float(loss2) / max(float(torch.trace(H2[:3, :3])), 1.0)) ** 0.5
    assert rms2 > 3 * rms, (rms, rms2)


def test_gn_recovers_relative_pose():
    prev = _prev(corridor_scan(np.random.default_rng(3), n=16000, end_wall=18.0),
                 np.zeros(6, np.float32))
    true_pose = np.array([1.0, 0.05, 0.02, 0.0, 0.0, 0.01], np.float32)
    world = corridor_scan(np.random.default_rng(4), n=16000, end_wall=18.0)
    pts_cur = _t(world_scan_at(world, true_pose))
    rv = torch.ones(len(pts_cur), dtype=torch.bool)
    pose = _t(true_pose + np.array([0.3, 0.1, 0.05, 0.0, 0.0, 0.02], np.float32))
    for _ in range(8):
        H, b, _ = ts2s.s2s_system(SP, prev, pose, pts_cur, rv)
        pose = pose - torch.linalg.solve(H + 1e-4 * torch.eye(6), b)
    err = np.abs(pose.numpy() - true_pose)
    assert err[0] < 3e-2, err
    assert err[1] < 2e-2 and err[2] < 2e-2, err
    assert err[5] < 2e-3, err


def test_empty_previous_scan_adds_nothing():
    """A resumed run's first frame has no previous points: the image is
    empty and the term contributes zeros."""
    prev = ts2s.build_prev_scan(SP, torch.zeros((1, 3)), torch.zeros(1, dtype=torch.bool),
                                torch.zeros(6))
    assert not bool(prev.pix_valid.any())
    pts = _t(corridor_scan(np.random.default_rng(5))[:512])
    H, b, loss = ts2s.s2s_system(SP, prev, torch.zeros(6), pts,
                                 torch.ones(len(pts), dtype=torch.bool))
    assert float(H.abs().max()) == 0.0 and float(b.abs().max()) == 0.0 and float(loss) == 0.0


def test_track_params_carry_s2s():
    cfg = load_config(CFG_PATH, CANON + ["tpu_specs.s2s_weight=10.0", "tpu_specs.s2s_elev=32",
                                         "tpu_specs.defer_sync=false"])
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")
    assert slam.tp.s2s == ts2s.Scan2ScanParams(
        weight=10.0, n_elev=32, n_az=1024, gate_dist=1.0, huber=0.2,
        min_depth=float(cfg.data_specs.get("min_depth", 0.5)), max_depth=slam.tp.max_depth)
    assert slam.tp_first.s2s == slam.tp.s2s
    adam = load_config(CFG_PATH, CANON + ["tpu_specs.s2s_weight=10.0", "tpu_specs.defer_sync=false",
                                          "tpu_specs.track_method=adam"])
    assert NerfLoamSLAM_torch(finalize(adam.as_dict()), None, device="cpu").tp.s2s is None
    assert ttr.TrackParams(1, 1, 0.3, 10.0, 1.0, 1.0).s2s is None


def test_kitti_quality_s2s_json_matches_jax_config():
    """The chip smoke's s2s path: the quality config plus s2s_weight 10 on the
    default 64 x 1024 image, as scripts/port_ate_reference.py --quality --s2s
    runs it through the JAX package."""
    sys.path.insert(0, ROOT)
    import bench

    ref = load_config(CFG_PATH, bench.BENCH_OVERRIDES + bench.QUALITY_OVERRIDES + [
        "tpu_specs.s2s_weight=10.0", "data_specs.n_frames=30", "tpu_specs.defer_sync=false"])
    cfg = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs",
                                        "kitti_quality_s2s.json"))
    assert cfg.as_dict() == ref.as_dict()
    sp = NerfLoamSLAM_torch(cfg, None, device="cpu").tp.s2s
    assert (sp.weight, sp.n_elev, sp.n_az, sp.min_depth, sp.max_depth) == (10.0, 64, 1024, 2.0, 40.0)


def test_pipeline_s2s_slice_matches_jax():
    """8 frames with the term on, through both packages."""
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM

    cfg = load_config(CFG_PATH, CANON + [
        "data_specs.n_frames=8", "debug_args.final_iter=0", "tpu_specs.s2s_weight=10.0",
        "tpu_specs.s2s_elev=32", "tpu_specs.s2s_az=256", "tpu_specs.defer_sync=false"])
    ds = get_dataset(cfg)
    gt = ds.gt_trajectory()[:8]
    jposes = np.asarray(NerfLoamSLAM(cfg, ds).run())
    n0 = ts2s.s2s_system_launches
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    tposes = np.asarray(slam.run())
    assert ts2s.s2s_system_launches == n0                     # CPU tensors take the twins
    assert tposes.shape == jposes.shape == (8, 4, 4)
    for poses in (jposes, tposes):
        assert np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 1.0
    gap = np.linalg.norm(tposes[:, :3, 3] - jposes[:, :3, 3], axis=1).max()
    ate_j, ate_t = ev.ate_rmse(jposes, gt, align=False), ev.ate_rmse(tposes, gt, align=False)
    print(f"s2s slice: max pose gap {gap:.4f} m, ATE jax {ate_j:.4f} m, port {ate_t:.4f} m")
    assert abs(ate_t - ate_j) <= 0.10, (ate_t, ate_j)
    assert gap <= 0.30, gap
