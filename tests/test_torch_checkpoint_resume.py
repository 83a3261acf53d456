"""Checkpoint roundtrip and bit-stable resume of the port on the CPU (the
scenario of tests/test_pipeline.py::test_resume_bit_stable within the
port), its own file beside tests/test_torch_checkpoint.py, whose config
and helpers it runs, so that the test runner's workers can take the two
files side by side. Everything compared here is compared exactly."""

import json
import os

import numpy as np
import pytest

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.utils import checkpoint as tckpt
from nerfloam_tpu_torch.utils.config import finalize

from test_torch_checkpoint import CFG_PATH, SAVED, SLICE, _assert_same, _frames, _snapshot, _start


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Frames 0-3, save; the same object goes on through frames 4-7 and
    finalize; a fresh object loads the checkpoint and does the same."""
    cfg = finalize(load_config(CFG_PATH, SLICE).as_dict())
    ds = get_dataset(cfg)
    a = NerfLoamSLAM_torch(cfg, ds, device="cpu")
    _start(a, ds, 3)
    path = str(tmp_path_factory.mktemp("ckpt") / "mid")
    tckpt.save_checkpoint(path, a)
    out = {"path": path, "saved": _snapshot(a)}
    b = NerfLoamSLAM_torch(cfg, ds, device="cpu")
    tckpt.load_checkpoint(path, b)
    out["loaded"] = _snapshot(b)
    for slam, key in ((a, "continued"), (b, "resumed")):
        for f in _frames(slam, ds, range(4, 8)):
            slam.process_frame(f)
        out[key + "_poses"] = np.asarray(slam.finalize())
        out[key] = _snapshot(slam)
    return out


def test_checkpoint_roundtrip(resumed):
    _assert_same(resumed["saved"], resumed["loaded"])
    assert resumed["saved"]["frames_processed"] == 4 and len(resumed["saved"]["keyframes"]) >= 1
    with open(os.path.join(resumed["path"], "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(resumed["path"], "state.npz"))
    assert {f"map_{n}" for n in SAVED} <= set(data.files)
    assert not any(f"map_{n}" in data.files for n in tckpt.DERIVED_MAP_FIELDS)
    assert "torch_generator" in data.files and "jax_key" not in data.files
    # the deferred schedule's device pose recurrence, NaN for a synchronous run (as JAX writes it)
    assert {k for k in data.files if k.startswith("dev_")} == {"dev_last_pose6", "dev_prev_pose6"}
    assert np.isnan(data["dev_last_pose6"]).all() and np.isnan(data["dev_prev_pose6"]).all()
    assert manifest["bf16_as_uint16"] == [] and manifest["frames_processed"] == 4


def test_resume_bit_stable(resumed):
    """Interrupt + resume replays identically to an uninterrupted run."""
    np.testing.assert_array_equal(resumed["continued_poses"], resumed["resumed_poses"])
    assert resumed["continued_poses"].shape == (8, 4, 4)
    _assert_same(resumed["continued"], resumed["resumed"])
    assert resumed["continued"]["frames_processed"] == 8
