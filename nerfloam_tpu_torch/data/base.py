"""Dataset base: the reference DataLoader contract (copy of
nerfloam_tpu/data/base.py with its numpy paths only; the JAX package's
native C++ filter and segmenter are not carried over).

__getitem__ -> (index, points (N,3) f32, points_cos (N,) f32, pose | None)
with range filtering and ground-cosine computation, matching
NeRF-LOAM src/dataset/kitti.py:75-81. Poses (use_gt) come from
KITTI-format text files; ``get_init_pose`` supplies the first-frame pose.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from nerfloam_tpu_torch.data.ground import segment_ground


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
        """z cutoff + range ball on a raw (N, >=3) scan."""
        pts = raw[:, :3]
        if np.isfinite(self.z_min):
            pts = pts[pts[:, 2] > self.z_min]
        return self.filter_range(pts)

    def __getitem__(self, index: int):
        points = self.filter_scan(self.read_scan(index).astype(np.float32))
        _, cos = segment_ground(points)
        pose = (
            np.concatenate((self.gt_pose[index], [0, 0, 0, 1])).reshape(4, 4)
            if self.use_gt
            else None
        )
        return index, points, cos, pose
