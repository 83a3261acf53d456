"""demo/run_torch.py on the CPU: a run of the slice's config with periodic
checkpoints writes its pose files, mesh and checkpoints, and a second run
resumed from the frame-2 checkpoint (--resume) ends with the same poses,
compared exactly. Its own file, apart from tests/test_torch_checkpoint.py,
so that the test runner's workers can take the two files side by side."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from nerfloam_tpu.utils.config import load_config

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
SLICE = CANON + ["data_specs.n_frames=8", "tpu_specs.bootstrap_steps=3", "tpu_specs.sampler=hits",
                 "tpu_specs.track_method=gn", "tpu_specs.recenter_margin=8.0",
                 "tpu_specs.defer_sync=false", "tpu_specs.bias_correction=true"]


def test_demo_run_torch_cpu(tmp_path):
    cfg = load_config(CFG_PATH, SLICE + ["data_specs.n_frames=4"]).as_dict()
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    # the run's own process takes the test's two threads, not every core
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "2"}
    base = [sys.executable, os.path.join(ROOT, "demo", "run_torch.py"), str(tmp_path / "cfg.json"),
            "--device", "cpu", "--set", f"log_dir={tmp_path}", "--set", "debug_args.ckpt_freq=2"]
    out = subprocess.run(base + ["--set", "exp_name=first"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: 4 poses" in out.stdout and "track" in out.stdout
    (run_dir,) = (tmp_path / "first").iterdir()
    for rel in ("misc/frame_poses.npy", "misc/frame_poses.txt", "mesh/final_mesh.ply",
                "ckpt/final/state.npz", "ckpt/00002/manifest.json", "bak/config.json"):
        assert (run_dir / rel).is_file(), rel
    first = np.load(run_dir / "misc" / "frame_poses.npy")
    out = subprocess.run(base + ["--set", "exp_name=second", "--resume",
                                 str(run_dir / "ckpt" / "00002")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from" in out.stdout and "at frame 2" in out.stdout
    (run2,) = (tmp_path / "second").iterdir()
    np.testing.assert_array_equal(np.load(run2 / "misc" / "frame_poses.npy"), first)
