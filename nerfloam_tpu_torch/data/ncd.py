"""Newer College dataset (Ouster OS1-64 .pcd scans).

Copy of nerfloam_tpu/data/ncd.py (numpy only): the port imports nothing
of the JAX package.

Equivalent of NeRF-LOAM src/dataset/ncd.py: pcd/{:05d}.pcd files with
a +500 index offset (ncd.py:50), hard-coded init pose when no GT
(ncd.py:34-37), poses.txt GT otherwise.
"""

from __future__ import annotations

import os.path as osp
from glob import glob

import numpy as np

from nerfloam_tpu_torch.data.base import LidarDataset
from nerfloam_tpu_torch.data.pcd_io import read_pcd

_INIT_POSE = np.array(
    [
        [5.925493285036220747e-01, -8.038419275143061649e-01, 5.218676416200035417e-02, -2.422443415414985424e-01],
        [8.017167514002809803e-01, 5.948020209102693467e-01, 5.882863457495644127e-02, 3.667865561670570873e+00],
        [-7.832971094540422397e-02, 6.980134849334420320e-03, 9.969030746023688216e-01, 6.809443654823238434e-01],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


class DataLoader(LidarDataset):
    pose_file = "poses.txt"
    index_offset = 500  # ncd.py:50

    def __init__(self, data_path, use_gt=False, max_depth=-1, min_depth=-1):
        self.num_bin = len(glob(osp.join(data_path, "pcd/*.pcd")))
        super().__init__(data_path, use_gt, max_depth, min_depth)

    def get_init_pose(self, frame: int) -> np.ndarray:
        if self.gt_pose is not None:
            return super().get_init_pose(frame)
        return _INIT_POSE.copy()

    def read_scan(self, index: int) -> np.ndarray:
        path = osp.join(
            self.data_path, "pcd/{:05d}.pcd".format(index + self.index_offset)
        )
        return read_pcd(path)

    def __len__(self):
        return self.num_bin
