"""The reference-exact fallbacks as whole runs on the CPU, beside the JAX
package (the fallbacks' pieces: tests/test_torch_exact.py):
- a 6-frame slice of synthetic_small.yaml with all four fallbacks (f32
  embeddings, exact gradients, superset 0, the Adam tracker with fresh
  rays) on both sides: ATE under 0.30 m each and within 0.20 m of each
  other (the Adam slice's bounds, test_torch_adam.py; the random streams
  differ), no touched voxel and no update count, and a checkpoint of the
  port's run loads back equal;
- kitti_exact.json equals the JAX package's config of the overrides
  scripts/port_ate_reference.py --adam25 --exact runs.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from nerfloam_tpu.core.pipeline import NerfLoamSLAM
from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.utils.config import finalize, load_json_config

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")


SLICE = CANON + [
    "data_specs.n_frames=6",
    "tpu_specs.bootstrap_steps=4",
    "tpu_specs.track_method=adam",
    "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=false",
    "tpu_specs.emb_dtype=float32",
    "tpu_specs.exact_embedding_grads=true",
    "tpu_specs.ba_ray_superset=0",
    "tpu_specs.track_resample_rays=true",
]


@pytest.fixture(scope="module")
def exact_runs():
    cfg = load_config(CFG_PATH, SLICE)
    ds = get_dataset(cfg)
    gt = ds.gt_trajectory()
    jax_poses = np.asarray(NerfLoamSLAM(cfg, ds).run())
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    port_poses = np.asarray(slam.run())
    return cfg, gt, jax_poses, port_poses, slam


def test_fallback_slice_matches_jax(exact_runs, tmp_path):
    from nerfloam_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg, gt, jax_poses, port_poses, slam = exact_runs
    assert slam.tp.resample_rays and slam.bp_current.exact_embedding_grads
    assert slam.bp_random.ray_superset == 0 and slam.track_method == "adam"
    assert port_poses.shape == jax_poses.shape == (6, 4, 4)
    ate_jax = ev.ate_rmse(jax_poses, gt[:6], align=False)
    ate_port = ev.ate_rmse(port_poses, gt[:6], align=False)
    assert ate_jax < 0.30, ate_jax
    assert ate_port < 0.30, ate_port
    assert abs(ate_port - ate_jax) <= 0.20, (ate_port, ate_jax)
    assert slam.dropped_delta_events == 0 and slam.overflow_events["touched"] == 0
    ms = slam.state.map_state
    assert int(ms.upd_count.sum()) == 0  # no voxel is ever marked touched
    # a resumed exact run loads: every table back as saved
    save_checkpoint(str(tmp_path / "ckpt"), slam)
    fresh = NerfLoamSLAM_torch(finalize(cfg.as_dict()), None, device="cpu")
    load_checkpoint(str(tmp_path / "ckpt"), fresh)
    for name in ("embeddings", "packed", "corner_idx", "active_ids", "upd_count"):
        assert torch.equal(getattr(fresh.state.map_state, name), getattr(ms, name)), name


def test_kitti_exact_json_matches_jax_config():
    sys.path.insert(0, ROOT)
    import bench

    spec = importlib.util.spec_from_file_location(
        "port_ate_reference", os.path.join(ROOT, "scripts", "port_ate_reference.py"))
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    ref = load_config(CFG_PATH, bench.BENCH_OVERRIDES + ref_mod.ADAM25 + ref_mod.EXACT
                      + ["data_specs.n_frames=30", "tpu_specs.defer_sync=false"])
    cfg = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs",
                                        "kitti_exact.json"))
    assert cfg.as_dict() == ref.as_dict()
    slam = NerfLoamSLAM_torch(cfg, None, device="cpu")
    assert slam.track_method == "adam" and slam.tp.resample_rays
    assert slam.bp_current.exact_embedding_grads and slam.bp_current.ray_superset == 0
    assert slam.map_cfg.emb_dtype == "float32" and slam.compute_dtype == "bfloat16"
    assert slam.state.map_state.embeddings.dtype == torch.float32
