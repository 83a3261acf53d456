"""MaiCity synthetic LiDAR dataset.

Copy of nerfloam_tpu/data/maicity.py (numpy only): the port imports nothing
of the JAX package.

Equivalent of NeRF-LOAM src/dataset/maicity.py: velodyne/{:05d}.bin
float32 (N,4) scans (no z filter), poses.txt GT.
"""

from __future__ import annotations

import os.path as osp
from glob import glob

import numpy as np

from nerfloam_tpu_torch.data.base import LidarDataset


class DataLoader(LidarDataset):
    pose_file = "poses.txt"

    def __init__(self, data_path, use_gt=False, max_depth=-1, min_depth=-1):
        self.num_bin = len(glob(osp.join(data_path, "velodyne/*.bin")))
        super().__init__(data_path, use_gt, max_depth, min_depth)

    def read_scan(self, index: int) -> np.ndarray:
        path = osp.join(self.data_path, "velodyne/{:05d}.bin".format(index))
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def __len__(self):
        return self.num_bin
