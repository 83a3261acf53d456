"""Subscene map partitioning: long sequences as a chain of bounded submaps
(port of nerfloam_tpu/parallel/subscene.py, its names and control flow).

The reference offers this only as a non-vendored git branch ("to process it
more fast", NeRF-LOAM Readme.md:97-104): partition the trajectory into
subscenes, run SLAM per subscene, concatenate the meshes. Here it is a
first-class runner. Each subscene gets a fresh pipeline and map (bounded
memory: nothing of a finished submap is kept) and starts from the previous
subscene's last tracked pose, read after its ``finalize()``: that is the
pose of the previous subscene's last frame, one frame's motion behind the
new first frame, as in the JAX package. Meshes are concatenated with vertex
offsets; trajectories chain directly.

Independent sequences (or subscene chains) run with one worker thread per
device and no communication between them (``run_sequences_parallel``).

Both run on the CUDA device(s) unless the caller names a CPU device; with
no CUDA device and no device named, they raise.
"""

from __future__ import annotations

import concurrent.futures
import contextlib

import numpy as np
import torch

from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}; pass device='cpu' to run on the CPU")
    return device


def run_sequences_parallel(jobs, devices=None):
    """Independent sequences (or subscene chains) run concurrently, one
    worker thread per device, with no cross-device communication: each
    pipeline's tensors live on its device, and its kernels launch there
    (``torch.cuda.device``). With more jobs than devices a worker takes
    them one after another; on one card they run in turn.

    ``jobs``: list of (cfg, dataset) pairs; ``devices``: torch devices
    (default every CUDA device). Returns a list of
    {"poses": [...], "mesh": (verts, faces), "device": str} in job order.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("run_sequences_parallel: no CUDA device; pass devices=[...] "
                               "to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_cuda_device(d) for d in devices]

    def _one(i, cfg, dataset):
        dev = devices[i % len(devices)]
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            slam = NerfLoamSLAM_torch(cfg, dataset, device=dev)
            poses = slam.run()
            verts, faces = slam.extract_mesh()
        return {"poses": poses, "mesh": (verts, faces), "device": str(dev)}

    with concurrent.futures.ThreadPoolExecutor(
        max_workers=min(len(jobs), len(devices))
    ) as ex:
        futs = [ex.submit(_one, i, c, d) for i, (c, d) in enumerate(jobs)]
        return [f.result() for f in futs]


class SubsceneRunner:
    def __init__(self, cfg, dataset, device="cuda", logger=None,
                 frames_per_subscene: int = 500):
        self.cfg = cfg
        self.dataset = dataset
        self.device = _cuda_device(device)
        self.logger = logger
        self.frames_per_subscene = frames_per_subscene

    def run(self):
        """Every frame, ``frames_per_subscene`` to a submap; returns (the
        chained poses, (vertices, faces) of the concatenated mesh, the
        number of subscenes). With a logger, writes the mesh as
        final_mesh_subscenes.ply and the poses as frame_poses."""
        tspec = self.cfg.tracker_specs
        start = int(tspec.get("start_frame", 0))
        end = int(tspec.get("end_frame", -1))
        stride = int(tspec.get("read_offset", 1))
        n = len(self.dataset)
        if end <= 0:
            end = n - 1
        end = min(end, n - 1)

        all_poses = []
        all_verts, all_faces = [], []
        init_pose = self.dataset.get_init_pose(start)
        sub_idx = 0
        frame_id = start
        while frame_id <= end:
            sub_end = min(frame_id + self.frames_per_subscene - 1, end)
            slam = NerfLoamSLAM_torch(self.cfg, self.dataset, device=self.device, logger=None)

            idx, pts, cos, pose = self.dataset[frame_id]
            first = Frame.from_raw(idx, pts, cos, None, slam.points_pad,
                                   has_gt_pose=pose is not None)
            first.pose6 = pose6_from_matrix_np(init_pose)
            slam.process_first_frame(first)

            for fid in range(frame_id + 1, sub_end + 1):
                if fid % stride != 0:
                    continue
                idx, pts, cos, pose = self.dataset[fid]
                f = Frame.from_raw(idx, pts, cos, pose, slam.points_pad,
                                   has_gt_pose=pose is not None)
                slam.process_frame(f)

            poses = slam.finalize()
            all_poses.extend(poses)
            v, fcs = slam.extract_mesh()
            if len(v):
                offset = sum(len(x) for x in all_verts)
                all_verts.append(v)
                all_faces.append(fcs + offset)

            # chain: the next subscene starts at this subscene's last tracked
            # pose (finalize() has drained the frame in flight)
            init_pose = slam.state.last_frame.pose_matrix()
            frame_id = sub_end + 1
            sub_idx += 1
            del slam  # free the submap

        verts = np.concatenate(all_verts) if all_verts else np.zeros((0, 3), np.float32)
        faces = np.concatenate(all_faces) if all_faces else np.zeros((0, 3), np.int32)
        if self.logger is not None:
            self.logger.log_mesh(verts, faces, name="final_mesh_subscenes.ply")
            self.logger.log_numpy_data(np.asarray(all_poses), "frame_poses")
        return all_poses, (verts, faces), sub_idx
