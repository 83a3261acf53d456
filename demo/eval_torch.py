"""Evaluation CLI of the PyTorch + CUDA port: trajectory ATE and mesh
quality (SHINE-mapping protocol), as demo/eval.py, on the port's own
modules (nerfloam_tpu_torch.utils.evaluation, utils.logger.read_ply,
map.mesher): it imports neither jax, yaml nor the JAX package, so it runs
beside the port on a machine that has none of them.

Usage:
  python demo/eval_torch.py traj --est logs/.../frame_poses.npy --gt poses_gt.txt
  python demo/eval_torch.py mesh --mesh logs/.../final_mesh.ply --gt-cloud gt.ply \
      [--f-threshold 0.1] [--crop-to-est | --crop-observed obs.ply] [--clean-with obs.ply]

Prints one JSON object: ate_rmse_raw_m, ate_rmse_aligned_m and n_poses, or
the mesh metrics (accuracy_m, completeness_m, chamfer_l1_m, precision,
recall, f_score).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np

from nerfloam_tpu_torch.utils import evaluation as ev
from nerfloam_tpu_torch.utils.logger import read_ply


def load_traj(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        arr = np.loadtxt(path)
    if arr.ndim == 2 and arr.shape[1] in (12, 16):
        arr = arr[:, :12].reshape(-1, 3, 4)
        pad = np.tile(np.array([[[0, 0, 0, 1.0]]]), (len(arr), 1, 1))
        arr = np.concatenate([arr, pad], axis=1)
    return arr


def load_cloud(path: str) -> np.ndarray:
    """(N, 3) float32 points from .npy / .ply / whitespace xyz text."""
    if path.endswith(".npy"):
        return np.load(path)[:, :3].astype(np.float32)
    if path.endswith(".ply"):
        pts, _ = read_ply(path)
        return pts
    return np.loadtxt(path)[:, :3].astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description="Trajectory ATE and mesh quality of a port run.")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("traj")
    t.add_argument("--est", required=True)
    t.add_argument("--gt", required=True)
    m = sub.add_parser("mesh")
    m.add_argument("--mesh", required=True)
    m.add_argument("--gt-cloud", required=True)
    m.add_argument("--f-threshold", type=float, default=0.1)
    m.add_argument("--n-samples", type=int, default=200000)
    m.add_argument(
        "--crop-to-est", action="store_true",
        help="crop the GT cloud to the est mesh bounding box + 0.5 m "
             "(coarse proxy; prefer --crop-observed, which implements "
             "SHINE's observed-region cropping)")
    m.add_argument(
        "--crop-observed", default=None,
        help="observed point cloud (ply/npy/txt): keep only GT points "
             "within --crop-radius of it (SHINE observed-region protocol; "
             "evaluation.crop_to_observed)")
    m.add_argument("--crop-radius", type=float, default=0.5)
    m.add_argument(
        "--clean-with", default=None,
        help="observed point cloud (ply/npy/txt) — cull mesh faces with no "
             "vertex within --clean-radius of it before sampling "
             "(reference clean_mesh, mesh_util.py:90-102)")
    m.add_argument("--clean-radius", type=float, default=0.15)
    args = p.parse_args(argv)

    if args.cmd == "traj":
        est, gt = load_traj(args.est), load_traj(args.gt)
        out = {
            "ate_rmse_raw_m": ev.ate_rmse(est, gt, align=False),
            "ate_rmse_aligned_m": ev.ate_rmse(est, gt, align=True),
            "n_poses": int(min(len(est), len(gt))),
        }
    else:
        verts, faces = read_ply(args.mesh)
        gt_pts = load_cloud(args.gt_cloud)
        if args.clean_with:
            from nerfloam_tpu_torch.map.mesher import clean_mesh, downsample_points

            obs = load_cloud(args.clean_with)
            faces = clean_mesh(
                verts, faces, downsample_points(obs), args.clean_radius
            )
        samples = (
            ev.sample_mesh_surface(verts, faces, args.n_samples)
            if faces is not None and len(faces)
            else verts
        )
        if args.crop_observed:
            gt_pts = ev.crop_to_observed(
                gt_pts, load_cloud(args.crop_observed), args.crop_radius
            )
        elif args.crop_to_est:
            lo, hi = verts.min(0) - 0.5, verts.max(0) + 0.5
            keep = np.all((gt_pts >= lo) & (gt_pts <= hi), axis=1)
            gt_pts = gt_pts[keep]
        out = ev.mesh_metrics(samples, gt_pts, f_threshold=args.f_threshold)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
