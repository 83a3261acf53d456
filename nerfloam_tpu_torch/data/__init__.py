"""Dataset registry (copy of nerfloam_tpu/data/__init__.py: the port
imports nothing of the JAX package).

Equivalent of the reference's dynamic import factory (NeRF-LOAM src/
utils/import_util.py:4-6) plus a ``synthetic`` dataset for tests and
benchmarks (the reference had no fixtures at all).
"""

from __future__ import annotations

import importlib

import numpy as np


def get_dataset(cfg):
    name = cfg.dataset
    if name == "synthetic":
        return SyntheticDataset(
            n_frames=int(cfg.data_specs.get("n_frames", 50)),
            max_depth=float(cfg.data_specs.get("max_depth", 30.0)),
            min_depth=float(cfg.data_specs.get("min_depth", 1.0)),
            use_gt=bool(cfg.data_specs.get("use_gt", False)),
            seed=int(cfg.data_specs.get("seed", 0)),
            n_beams=int(cfg.data_specs.get("n_beams", 32)),
            n_azimuth=int(cfg.data_specs.get("n_azimuth", 512)),
            step=float(cfg.data_specs.get("traj_step", 0.4)),
            yaw_rate=float(cfg.data_specs.get("yaw_rate", 0.004)),
            noise=float(cfg.data_specs.get("noise", 0.0)),
            world=str(cfg.data_specs.get("world", "boxes")),
        )
    mod = importlib.import_module(f"nerfloam_tpu_torch.data.{name}")
    return mod.DataLoader(
        cfg.data_specs["data_path"],
        use_gt=bool(cfg.data_specs.get("use_gt", False)),
        max_depth=float(cfg.data_specs.get("max_depth", -1)),
        min_depth=float(cfg.data_specs.get("min_depth", -1)),
    )


class SyntheticDataset:
    """Procedural LiDAR sequence over data/synthetic.py worlds — same
    __getitem__ contract as the file-based datasets."""

    def __init__(self, n_frames=50, max_depth=30.0, min_depth=1.0, use_gt=False,
                 seed=0, n_beams=32, n_azimuth=512, step=0.4, yaw_rate=0.0,
                 noise=0.0, world="boxes"):
        from nerfloam_tpu_torch.data import synthetic as syn

        if world == "kitti_replica":
            # KITTI-statistics corridor: segmented trajectory (straights,
            # 90-deg turns, highway stretch) + facades/cars/poles/guardrails,
            # HDL-64E beam pattern (VERDICT r2 item 1)
            self.poses, urban = syn.kitti_trajectory(n_frames, seed=seed)
            self.world = syn.make_kitti_world(self.poses, urban, seed=seed)
            self.dirs = (
                syn.hdl64_dirs(n_azimuth)
                if n_beams >= 64
                else syn.lidar_dirs(n_beams=n_beams, n_azimuth=n_azimuth)
            )
        else:
            self.world = syn.make_world(seed=seed, n_boxes=14, extent=25.0)
            self.poses = syn.straight_trajectory(
                n_frames, step=step, yaw_rate=yaw_rate
            )
            self.dirs = syn.lidar_dirs(n_beams=n_beams, n_azimuth=n_azimuth)
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.use_gt = use_gt
        self.noise = noise
        self.rng = np.random.default_rng(seed + 1)
        self._syn = syn

    def __len__(self):
        return len(self.poses)

    def get_init_pose(self, frame):
        return self.poses[frame]

    def gt_trajectory(self):
        return self.poses

    def __getitem__(self, index):
        local = self._syn.boxes_near(
            self.world, self.poses[index][:3, 3], self.max_depth
        )
        pts, cos = self._syn.render_scan(
            local, self.poses[index], self.dirs,
            max_depth=self.max_depth, min_depth=self.min_depth,
            noise=self.noise, rng=self.rng,
        )
        pose = self.poses[index] if self.use_gt else None
        return index, pts, cos, pose
