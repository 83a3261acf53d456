"""ATE of the JAX package on the configs the PyTorch port runs in
chip_smoke.py, measured on the CPU: the reference its ATE bound is made of.

    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py            # kitti_budget.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality  # kitti_quality.json

The config is synthetic_small.yaml + bench.BENCH_OVERRIDES (+ QUALITY_OVERRIDES)
+ 30 frames, defer_sync off, i.e. the port's JSON config of the same name;
frames are fed as bench.py feeds them. Prints one JSON line with the
unaligned ATE RMSE (m) of the finalized trajectory.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from nerfloam_tpu.core.frame import Frame, pose6_from_matrix_np  # noqa: E402
from nerfloam_tpu.core.pipeline import NerfLoamSLAM  # noqa: E402
from nerfloam_tpu.data import get_dataset  # noqa: E402
from nerfloam_tpu.utils import evaluation  # noqa: E402
from nerfloam_tpu.utils.config import load_config  # noqa: E402


def main():
    quality = "--quality" in sys.argv
    overrides = (bench.BENCH_OVERRIDES + (bench.QUALITY_OVERRIDES if quality else [])
                 + ["data_specs.n_frames=30", "tpu_specs.defer_sync=false"])
    cfg = load_config(os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml"),
                      overrides)
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM(cfg, ds)
    frames = []
    for i in range(len(ds)):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    t0 = time.perf_counter()
    slam.process_first_frame(frames[0])
    for f in frames[1:]:
        slam.process_frame(f)
    poses = np.asarray(slam.finalize())
    gt = ds.gt_trajectory()[: len(poses)]
    print(json.dumps({
        "config": "kitti_quality" if quality else "kitti_budget",
        "frames": len(poses),
        "ate_m": float(evaluation.ate_rmse(poses, gt, align=False)),
        "sdf_bias": [float(x) for x in slam.sdf_bias],
        "overflow_events": {k: int(v) for k, v in slam.overflow_events.items()},
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
