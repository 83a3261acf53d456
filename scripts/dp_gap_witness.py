"""How far ray data parallelism moves a whole run, in the JAX package and in
the port, on the CPU: the same config and seed run with dp=1 and with dp=4
in each package, each frame's tracked pose6 compared between the two runs
(largest absolute entry gap; translation in m, rotation vector in rad).

dp changes only the order of float sums (the tracker's normal equations,
BA's loss counts and gradients), so the gap is what that order alone does to
a run. JAX's dp=4 runs under shard_map on 8 virtual CPU devices; the port's
as four gloo ranks (``parallel.sharding.run_dp``).

    python scripts/dp_gap_witness.py [--frames 6] [--set group.key=value ...]

The config is configs/synthetic/synthetic_small.yaml with the overrides of
tests/test_sharding.py::test_pipeline_dp_runs_and_tracks. A few minutes on
four cores. Prints one line for each package and the JSON of the gaps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
OVERRIDES = ["tpu_specs.bootstrap_steps=4", "tracker_specs.num_iterations=10",
             "mapper_specs.num_iterations=10"]


def pose6_of(mats) -> np.ndarray:
    """(F, 4, 4) poses -> (F, 6) [t, w], the port's log_so3 in float32."""
    import torch

    from nerfloam_tpu_torch.ops import se3

    m = torch.as_tensor(np.asarray(mats, np.float32))
    return se3.pose_from_matrix(m).numpy()


def raw_track(slam, rank):
    """run_dp's probe: a rank's tracked poses."""
    return np.stack([np.asarray(t, np.float64) for t in slam.get_raw_trajectory()])


def run_jax(overrides):
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM
    from nerfloam_tpu.data import get_dataset
    from nerfloam_tpu.utils.config import load_config

    out = {}
    for dp in (1, 4):
        cfg = load_config(CFG_PATH, overrides + [f"tpu_specs.dp={dp}"])
        slam = NerfLoamSLAM(cfg, get_dataset(cfg))
        slam.run()
        out[dp] = pose6_of(np.stack([np.asarray(t) for t in slam.get_raw_trajectory()]))
    return out


def run_port(overrides):
    from nerfloam_tpu.utils.config import load_config
    from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
    from nerfloam_tpu_torch.data import get_dataset
    from nerfloam_tpu_torch.parallel import sharding
    from nerfloam_tpu_torch.utils.config import finalize

    cfg = finalize(load_config(CFG_PATH, overrides + ["tpu_specs.dp=1"]).as_dict())
    slam = NerfLoamSLAM_torch(cfg, get_dataset(cfg), "cpu")
    slam.run()
    one = pose6_of(np.stack([np.asarray(t) for t in slam.get_raw_trajectory()]))
    res = sharding.run_dp(cfg, get_dataset, 4, ["cpu"] * 4, "gloo", probe=raw_track)
    return {1: one, 4: pose6_of(res["probe"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--set", action="append", default=[], metavar="group.key=value")
    args = ap.parse_args()
    overrides = OVERRIDES + [f"data_specs.n_frames={args.frames}"] + args.set
    result = {}
    for name, fn in (("jax", run_jax), ("port", run_port)):
        t0 = time.perf_counter()
        runs = fn(overrides)
        gaps = np.abs(runs[4] - runs[1]).max(axis=1)
        result[name] = [float(g) for g in gaps]
        print(f"{name}: dp=4 against dp=1, each frame's tracked pose6 gap: "
              + ", ".join(f"{g:.3g}" for g in gaps) + f" ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"overrides": overrides, "tracked_pose6_gap": result}))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    main()
