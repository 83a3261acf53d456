"""A run of the port with a logger on the CPU (pose files, meshes,
periodic checkpoints and debug blobs), its mesh extract, and a run resumed
from one of its periodic checkpoints ending with its poses. Its own file
beside tests/test_torch_checkpoint.py, whose config it runs, so that the
test runner's workers can take the two files side by side. Everything
compared here is compared exactly."""

import os
import pickle

import numpy as np
import pytest

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.utils import checkpoint as tckpt
from nerfloam_tpu_torch.utils.config import finalize
from nerfloam_tpu_torch.utils.logger import RunLogger, read_ply

from test_torch_checkpoint import CFG_PATH, SLICE


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """A 6-frame run() with a logger, a mesh every 4th frame, a checkpoint
    every 2nd and a debug blob every 3rd."""
    cfg = finalize(load_config(CFG_PATH, SLICE + [
        "data_specs.n_frames=6", "debug_args.mesh_freq=4", "debug_args.ckpt_freq=2",
        "debug_args.save_data_freq=3"]).as_dict())
    ds = get_dataset(cfg)
    logger = RunLogger(str(tmp_path_factory.mktemp("logs")), "run", config=cfg.as_dict())
    slam = NerfLoamSLAM_torch(cfg, ds, device="cpu", logger=logger)
    poses = np.asarray(slam.run())
    return cfg, ds, slam, logger, poses


def test_logger_run_writes_outputs(logged):
    cfg, ds, slam, logger, poses = logged
    d = logger.dir
    saved = np.load(os.path.join(d, "misc", "frame_poses.npy"))
    np.testing.assert_array_equal(saved, poses)
    assert poses.shape == (6, 4, 4)
    txt = np.loadtxt(os.path.join(d, "misc", "frame_poses.txt"))
    np.testing.assert_allclose(txt, poses[:, :3, :].reshape(6, 12))
    raw = np.load(os.path.join(d, "misc", "tracking_trajectory.npy"))
    np.testing.assert_array_equal(raw, np.asarray(slam.get_raw_trajectory()))
    for name in ("final_mesh.ply", "final_mesh_noreplay.ply", "mesh_00004.ply"):
        v, f = read_ply(os.path.join(d, "mesh", name))
        assert len(v) > 1000 and f is not None and len(f) > 1000, name
        assert np.isfinite(v).all() and f.min() >= 0 and f.max() < len(v)
    v, f = read_ply(os.path.join(d, "mesh", "final_mesh.ply"))
    mv, mf = slam.extract_mesh()
    np.testing.assert_array_equal(v, mv)
    np.testing.assert_array_equal(f, mf)
    assert np.load(os.path.join(d, "misc", "frame_poses_00004.npy")).shape == (5, 4, 4)
    for stamp in ("00002", "00004"):
        assert os.path.isfile(os.path.join(d, "ckpt", stamp, "state.npz"))
        assert os.path.isfile(os.path.join(d, "ckpt", stamp, "manifest.json"))
    with open(os.path.join(d, "misc", "scene_data_3.pkl"), "rb") as fh:
        blob = pickle.load(fh)
    assert blob["frame_index"] == 3 and blob["num_lat"] > 0 and blob["n_keyframes"] >= 1


def test_extract_mesh_clean_and_observed_points(logged):
    _, _, slam, _, _ = logged
    obs = slam.observed_points()
    assert obs.ndim == 2 and obs.shape[1] == 3 and len(obs) > 1000
    v, f = slam.extract_mesh(clean=False)
    vc, fc = slam.extract_mesh(clean=True)
    np.testing.assert_array_equal(v, vc)
    assert 0 < len(fc) < len(f)
    v3, f3 = slam.extract_mesh(res=3)
    assert len(f3) > 2 * len(f)


def test_resume_run_from_periodic_checkpoint(logged):
    """run() on an object loaded from ckpt/00004 goes on after frame 4 and
    ends with the uninterrupted run's poses. (A periodic checkpoint is
    written inside frame 4's bookkeeping, before its count, as in JAX.)"""
    cfg, ds, _, logger, poses = logged
    slam = NerfLoamSLAM_torch(cfg, ds, device="cpu")
    tckpt.load_checkpoint(os.path.join(logger.dir, "ckpt", "00004"), slam)
    assert slam.state.last_frame.index == 4 and slam.state.frames_processed == 4
    again = np.asarray(slam.run())
    assert slam.state.last_frame.index == 5
    np.testing.assert_array_equal(again, poses)
