"""ATE of the JAX package on the configs the PyTorch port runs in
chip_smoke.py, measured on the CPU: the reference its ATE bound is made of.

    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py            # kitti_budget.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality  # kitti_quality.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --adam25   # kitti_adam25.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality --s2s  # kitti_quality_s2s.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --gate60 SEED  # replica_gate60.json

The KITTI-budget configs are synthetic_small.yaml + bench.BENCH_OVERRIDES
(+ QUALITY_OVERRIDES or ADAM25) + 30 frames, defer_sync off, i.e. the
port's JSON config of the same name; frames are fed as bench.py feeds
them. Prints one JSON line with the unaligned ATE RMSE (m) of the
finalized trajectory.

``--s2s`` adds the scan-to-scan term (``tpu_specs.s2s_weight=10.0``, image
64 x 1024) to the GN tracker of the chosen config.

ADAM25 is bench.ADAM25_OVERRIDES plus ``tpu_specs.track_method=adam``: the
pipeline reads the tracker choice from tpu_specs, so bench.py's
``tracker_specs.track_method=adam`` alone leaves the GN tracker on.

``--gate60 SEED`` runs the replica gate instead: kitti_replica_ci.yaml +
calibrate_gate60.GATE60 + LEAN + data_specs.seed=SEED, defer_sync off,
through NerfLoamSLAM.run() as scripts/eval_replica.py drives it, and
prints the raw and aligned ATE, the overflow accounting, the lateral
drift rate and each frame's raw translation error (m, no alignment: the
estimated position's distance to the ground truth's), with no mesh.
"""

import importlib.util
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

ADAM25 = bench.ADAM25_OVERRIDES + ["tpu_specs.track_method=adam"]
S2S = ["tpu_specs.s2s_weight=10.0"]


def gate60_overrides(seed: int) -> list:
    spec = importlib.util.spec_from_file_location(
        "calibrate_gate60", os.path.join(ROOT, "scripts", "calibrate_gate60.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GATE60 + mod.LEAN + [f"data_specs.seed={seed}", "tpu_specs.defer_sync=false"]


def drift_lat_cm_f(est: np.ndarray, gt: np.ndarray) -> float:
    """Mean lateral per-frame drift (cm/frame), scripts/eval_replica.py:99-111."""
    rel_e = np.linalg.inv(est[:-1]) @ est[1:]
    rel_g = np.linalg.inv(gt[:-1]) @ gt[1:]
    diff = rel_e[:, :3, 3] - rel_g[:, :3, 3]
    fwd = rel_g[:, :3, 3] / (np.linalg.norm(rel_g[:, :3, 3], axis=1, keepdims=True) + 1e-9)
    along = np.einsum("ij,ij->i", diff, fwd)
    return float(np.linalg.norm(diff - along[:, None] * fwd, axis=1).mean()) * 100


def gate60(seed: int):
    cfg = load_config(os.path.join(ROOT, "configs", "synthetic", "kitti_replica_ci.yaml"),
                      gate60_overrides(seed))
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM(cfg, ds)
    t0 = time.perf_counter()
    est = np.asarray(slam.run())
    gt = ds.gt_trajectory()[: len(est)]
    print(json.dumps({
        "config": "replica_gate60",
        "seed": seed,
        "frames": len(est),
        "ate_raw_m": evaluation.ate_rmse(est, gt, align=False),
        "ate_aligned_m": evaluation.ate_rmse(est, gt, align=True),
        "growth_events": int(sum(slam.overflow_events.values())),
        "overflow_events": {k: int(v) for k, v in slam.overflow_events.items()},
        "dropped_delta_events": int(slam.dropped_delta_events),
        "drift_lat_cm_f": drift_lat_cm_f(est, gt),
        "frame_err_m": [float(e) for e in np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)],
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(),
    }))


def main():
    if "--gate60" in sys.argv:
        return gate60(int(sys.argv[sys.argv.index("--gate60") + 1]))
    quality = "--quality" in sys.argv
    adam25 = "--adam25" in sys.argv
    s2s = "--s2s" in sys.argv
    overrides = (bench.BENCH_OVERRIDES + (bench.QUALITY_OVERRIDES if quality else [])
                 + (ADAM25 if adam25 else []) + (S2S if s2s else [])
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
        "config": ("kitti_quality" if quality else "kitti_adam25" if adam25
                   else "kitti_budget") + ("_s2s" if s2s else ""),
        "frames": len(poses),
        "ate_m": float(evaluation.ate_rmse(poses, gt, align=False)),
        "sdf_bias": [float(x) for x in slam.sdf_bias],
        "overflow_events": {k: int(v) for k, v in slam.overflow_events.items()},
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
