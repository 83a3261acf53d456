"""The port's slice as a whole: synthetic_small + the canonical test
budget + the bench row's sampler and schedule (hits sampler, GN tracker,
recenter_margin 8, defer_sync off), 10 frames through the JAX package and
through nerfloam_tpu_torch on the CPU. Random streams differ (threefry vs
Philox), so the runs are compared on ATE: both under the 0.30 m bound of
test_pipeline.py::test_trajectory_accuracy, and within 0.10 m of each
other. Also: the port imports neither jax, yaml nor the JAX package, the
KITTI-budget JSON equals the JAX package's config of the same overrides,
the quality-stack knobs construct, and every knob the port lacks raises
at construction."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import derive_static_shapes as j_shapes, load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.utils.config import derive_static_shapes, finalize, load_json_config

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


@pytest.fixture(scope="module")
def runs():
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM

    cfg = load_config(CFG_PATH, SLICE)
    ds = get_dataset(cfg)
    gt = ds.gt_trajectory()
    jax_poses = np.asarray(NerfLoamSLAM(cfg, ds).run())
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    port_poses = np.asarray(slam.run())
    return gt, jax_poses, port_poses, slam


def test_port_trajectory_matches_jax(runs):
    gt, jax_poses, port_poses, _ = runs
    assert port_poses.shape == jax_poses.shape == (10, 4, 4)
    ate_jax = ev.ate_rmse(jax_poses, gt[:10], align=False)
    ate_port = ev.ate_rmse(port_poses, gt[:10], align=False)
    assert ate_jax < 0.30, ate_jax
    assert ate_port < 0.30, ate_port
    assert abs(ate_port - ate_jax) <= 0.10, (ate_port, ate_jax)


def test_port_run_bookkeeping(runs):
    _, _, _, slam = runs
    st = slam.state
    assert st.frames_processed == 10
    assert len(st.tracking_trajectory) == 10
    assert len(st.frame_telemetry) == 9
    assert all(0.5 < hit <= 1.0 for _, hit, _ in st.frame_telemetry)
    assert len(st.keyframes) >= 1
    assert sum(slam.overflow_events.values()) == 0 and slam.dropped_delta_events == 0
    ms = st.map_state
    assert int(ms.n_active) > 0 and int(ms.num_lat) <= slam.map_cfg.capacity
    assert torch.isfinite(ms.embeddings.float()).all()
    # per tracked frame: one fetch of the results + one lazy-recenter branch
    assert slam.host_syncs <= 2 * 9 + 1 + 6 + 16


def test_port_imports_neither_jax_nor_yaml():
    code = (
        "import pkgutil, importlib, sys\n"
        "import nerfloam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'nerfloam_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) >= 15, mods\n"
        "bad = [m for m in ('jax', 'jaxlib', 'yaml', 'optax') if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m == 'nerfloam_tpu' or m.startswith('nerfloam_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_kitti_budget_json_matches_jax_config():
    sys.path.insert(0, ROOT)
    import bench

    ref = load_config(CFG_PATH, bench.BENCH_OVERRIDES + ["data_specs.n_frames=30",
                                                         "tpu_specs.defer_sync=false"])
    cfg = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs",
                                        "kitti_budget.json"))
    assert cfg.as_dict() == ref.as_dict()
    assert derive_static_shapes(cfg) == j_shapes(ref)
    assert derive_static_shapes(cfg)["grid_dim"] == (288, 288, 60)
    with open(os.path.join(ROOT, "nerfloam_tpu_torch", "configs", "kitti_budget.json")) as f:
        assert json.load(f)["tpu_specs"]["defer_sync"] is False


@pytest.mark.parametrize("knob", [
    "tpu_specs.sampler=grid", "tpu_specs.track_method=adam", "tpu_specs.defer_sync=true",
    "tpu_specs.dp=2", "tpu_specs.s2s_weight=5.0",
    "tpu_specs.exact_embedding_grads=true", "tpu_specs.maturity_warmup=4",
    "debug_args.mesh_freq=100", "tpu_specs.replay_freq=5", "tpu_specs.ba_pose_project=along",
    "mapper_specs.remove_back=true", "tpu_specs.bias_source=keyframe",
    "tpu_specs.bias_classes=2",
])
def test_unported_knobs_raise(knob):
    cfg = load_config(CFG_PATH, SLICE + [knob])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")


@pytest.mark.parametrize("knob, check", [
    ("tpu_specs.support_dist=-1",
     lambda s: s.map_cfg.support_dist == s.map_cfg.voxel_size and not s.map_cfg.support_sym),
    ("tpu_specs.band_samples=8",
     lambda s: s.tp.band_samples == 8 and s.bp_current.band_samples == 8),
    ("tpu_specs.surface_anchor=1",
     lambda s: s.tp.surface_anchor == 1 and s.bp_random.surface_anchor == 1),
    ("tpu_specs.bias_correction=true",
     lambda s: s.bias_correction and s.bp_current.measure_bias and s.bp_random.measure_bias),
])
def test_ported_knobs_construct(knob, check):
    """The quality-stack knobs (queue-1 item 10) no longer raise: each
    reaches the map, tracker and BA parameters it sets."""
    cfg = load_config(CFG_PATH, SLICE + [knob])
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")
    assert check(slam)
    assert not NerfLoamSLAM_torch(finalize(load_config(CFG_PATH, SLICE).as_dict()), None,
                                  device="cpu").bp_current.measure_bias


def test_logger_raises():
    cfg = finalize(load_config(CFG_PATH, SLICE).as_dict())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        NerfLoamSLAM_torch(cfg, None, device="cpu", logger=object())
