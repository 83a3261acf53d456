"""The port's budget overflows: each class (map capacity, touched voxels,
active set, insert candidates) is grown and its step replayed from the
pre-step state with the same random stream, as the JAX pipeline does, so
nothing is dropped. A run at tiny caps is compared with the same run at
caps that never overflow (4 frames of the slice's config)."""

import os

import numpy as np
import pytest
import torch

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.map.voxel_map import acap
from nerfloam_tpu_torch.utils.config import finalize

from _canon import CANON

torch.set_num_threads(2)
CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "synthetic",
                        "synthetic_small.yaml")
BASE = CANON + [
    "data_specs.n_frames=4", "tpu_specs.bootstrap_steps=4", "mapper_specs.final_iter=false",
    "tpu_specs.sampler=hits", "tpu_specs.track_method=gn", "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=false",
]


def _run(overrides):
    cfg = load_config(CFG_PATH, BASE + overrides)
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    return np.asarray(slam.run()), slam


@pytest.fixture(scope="module")
def roomy():
    poses, slam = _run([])
    assert sum(slam.overflow_events.values()) == 0
    return poses


# (overrides, classes that must overflow, trajectory tolerance). Capacity
# and touched growth keep every row id and sample, so the replay is
# bitwise. An active-set growth re-ranks the active ids (a full refresh),
# which only reorders float sums (measured 2.4e-7 m). A grown candidate
# budget compacts the insert, which renumbers lattice rows; the reordered
# sums then drift the 4-frame trajectory by up to 1.5 cm (measured), so
# that case is held to 5 cm.
CASES = {
    "capacity_touched": (["tpu_specs.map_capacity=8192", "tpu_specs.touched_cap=64"],
                         ("capacity", "touched"), 0.0),
    "active": (["tpu_specs.active_cap=512"], ("active",), 1e-5),
    "candidates": (["tpu_specs.insert_cand_cap=256"], ("cand",), 0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_overflow_grows_and_replays(roomy, case):
    overrides, classes, tol = CASES[case]
    poses, slam = _run(overrides)
    for c in classes:
        assert slam.overflow_events[c] > 0, slam.overflow_events
    assert slam.dropped_delta_events == 0
    assert slam.map_cfg.capacity >= 8192 and acap(slam.map_cfg) >= 512
    assert int(slam.state.map_state.n_active) <= acap(slam.map_cfg)
    assert int(slam.state.map_state.num_lat) <= slam.map_cfg.capacity
    np.testing.assert_allclose(poses, roomy, rtol=0, atol=tol)
