"""Dataset base: the reference DataLoader contract (copy of
nerfloam_tpu/data/base.py). ``__getitem__`` takes the JAX loader's default
path: the port's C++ range filter and ground segmenter
(``nerfloam_tpu_torch/native``), bit for bit what the JAX package feeds its
tracker. ``filter_scan`` and ``data/ground.segment_ground`` are their numpy
twins, kept for the tests; no path calls them.

__getitem__ -> (index, points (N,3) f32, points_cos (N,) f32, pose | None)
with range filtering and ground-cosine computation, matching
NeRF-LOAM src/dataset/kitti.py:75-81. Poses (use_gt) come from
KITTI-format text files; ``get_init_pose`` supplies the first-frame pose.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from nerfloam_tpu_torch.native import filter_scan_native, segment_ground_native


class LidarDataset:
    pose_file = "poses.txt"
    z_min = -np.inf  # vertical outlier cutoff (KITTI: -3 m, kitti.py:44-45)

    def __init__(self, data_path: str, use_gt: bool = False,
                 max_depth: float = -1, min_depth: float = -1):
        self.data_path = data_path
        self.use_gt = use_gt
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.gt_pose = self.load_gt_pose() if use_gt else None

    # -- to implement per dataset ------------------------------------------
    def read_scan(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # -- shared --------------------------------------------------------------
    def load_gt_pose(self):
        return np.loadtxt(osp.join(self.data_path, self.pose_file))

    def get_init_pose(self, frame: int) -> np.ndarray:
        if self.gt_pose is not None:
            return np.concatenate(
                (self.gt_pose[frame], [0, 0, 0, 1])
            ).reshape(4, 4)
        return np.eye(4)

    def filter_range(self, points: np.ndarray) -> np.ndarray:
        norm = np.linalg.norm(points[:, :3], axis=-1)
        mask = np.ones(len(points), bool)
        if self.max_depth != -1:
            mask &= norm < self.max_depth
        if self.min_depth != -1:
            mask &= norm > self.min_depth
        return points[mask]

    def filter_scan(self, raw: np.ndarray) -> np.ndarray:
        """z cutoff + range ball on a raw (N, >=3) scan: the numpy twin of
        ``filter_scan_native`` (the JAX package's fallback)."""
        pts = raw[:, :3]
        if np.isfinite(self.z_min):
            pts = pts[pts[:, 2] > self.z_min]
        return self.filter_range(pts)

    def __getitem__(self, index: int):
        raw = self.read_scan(index).astype(np.float32)
        # one C++ pass over the raw scan (z cutoff + range ball), then the
        # C++ segmenter; both release the GIL in the prefetching thread
        points = filter_scan_native(raw, self.z_min, self.min_depth, self.max_depth)
        _, cos = segment_ground_native(points)
        pose = (
            np.concatenate((self.gt_pose[index], [0, 0, 0, 1])).reshape(4, 4)
            if self.use_gt
            else None
        )
        return index, points, cos, pose
