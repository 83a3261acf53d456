"""The deferred schedule as a whole beside the JAX package's: the slice of
tests/test_torch_pipeline.py (synthetic_small + the canonical test budget,
hits sampler, GN tracker, recenter_margin 8) with ``defer_sync`` on, 10
frames through nerfloam_tpu and through nerfloam_tpu_torch on the CPU. The
random streams differ (threefry against Philox), so the runs are compared
as test_port_trajectory_matches_jax compares them: both ATEs under 0.30 m
and within 0.10 m of each other. The final replay is off on both sides
(``final_iter`` moves no pose). Also: the same bookkeeping on both sides,
nothing in flight after finalize, and a checkpoint the JAX package wrote
under defer_sync loads into the port with its device pose recurrence."""

import os

import numpy as np
import pytest
import torch

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.utils.bridge import load_jax_checkpoint
from nerfloam_tpu_torch.utils.config import finalize

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
N_FRAMES = 10
SLICE_DEFER = CANON + [
    f"data_specs.n_frames={N_FRAMES}",
    "tpu_specs.bootstrap_steps=6",
    "tpu_specs.sampler=hits",
    "tpu_specs.track_method=gn",
    "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=true",
    "mapper_specs.final_iter=false",
]


@pytest.fixture(scope="module")
def runs():
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM

    cfg = load_config(CFG_PATH, SLICE_DEFER)
    ds = get_dataset(cfg)
    jax_slam = NerfLoamSLAM(cfg, ds)
    jax_poses = np.asarray(jax_slam.run())
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    port_poses = np.asarray(slam.run())
    return ds.gt_trajectory(), jax_slam, jax_poses, slam, port_poses


def test_defer_trajectory_matches_jax(runs):
    gt, _, jax_poses, _, port_poses = runs
    assert port_poses.shape == jax_poses.shape == (N_FRAMES, 4, 4)
    ate_jax = ev.ate_rmse(jax_poses, gt[:N_FRAMES], align=False)
    ate_port = ev.ate_rmse(port_poses, gt[:N_FRAMES], align=False)
    assert ate_jax < 0.30, ate_jax
    assert ate_port < 0.30, ate_port
    assert abs(ate_port - ate_jax) <= 0.10, (ate_port, ate_jax)


def test_defer_bookkeeping_matches_jax(runs):
    _, jax_slam, _, slam, _ = runs
    assert slam.defer_sync and jax_slam.defer_sync
    assert slam.state.frames_processed == jax_slam.state.frames_processed == N_FRAMES
    assert len(slam.state.frame_telemetry) == len(jax_slam.state.frame_telemetry) == N_FRAMES - 1
    assert slam._inflight is None and jax_slam._inflight is None
    assert slam._defer_replays == jax_slam._defer_replays == 0
    assert slam.dropped_delta_events == jax_slam.dropped_delta_events == 0


def test_jax_defer_checkpoint_loads_into_port(runs, tmp_path):
    """The JAX package's checkpoint of its finished deferred run (its save
    writes the device pose recurrence) through load_jax_checkpoint: the
    port's pair is JAX's, bit for bit, and nothing is in flight."""
    from nerfloam_tpu.utils.checkpoint import save_checkpoint as jax_save

    _, jax_slam, _, slam, _ = runs
    jax_save(str(tmp_path), jax_slam)
    port = NerfLoamSLAM_torch(slam.cfg, None, device="cpu")
    load_jax_checkpoint(str(tmp_path), port)
    assert port._inflight is None
    for name in ("_dev_last_pose6", "_dev_prev_pose6"):
        want = np.asarray(getattr(jax_slam, name), np.float32)
        assert np.isfinite(want).all()
        np.testing.assert_array_equal(getattr(port, name).numpy(), want)
    np.testing.assert_array_equal(port._dev_last_pose6.numpy(), port.state.last_frame.pose6)
