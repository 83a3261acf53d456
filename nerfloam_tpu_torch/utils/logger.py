"""Run-directory logger (port of nerfloam_tpu/utils/logger.py, which imports
yaml): config backup as JSON, meshes as binary little-endian PLY written
with numpy, pose dumps as .npy plus KITTI-format .txt."""

from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray | None = None,
              colors: np.ndarray | None = None):
    """Binary PLY writer (vertices (V,3) f32, faces (F,3) int, colors (V,3) u8)."""
    vertices = np.asarray(vertices, np.float32)
    n_v = len(vertices)
    n_f = 0 if faces is None else len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n_v}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        if faces is not None:
            hdr += [f"element face {n_f}", "property list uchar int vertex_indices"]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode())
        if colors is not None:
            rec = np.empty(n_v, np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)]))
            rec["xyz"] = vertices
            rec["rgb"] = np.asarray(colors, np.uint8)
            rec.tofile(f)
        else:
            vertices.tofile(f)
        if faces is not None:
            rec = np.empty(n_f, np.dtype([("n", np.uint8), ("idx", np.int32, 3)]))
            rec["n"] = 3
            rec["idx"] = np.asarray(faces, np.int32)
            rec.tofile(f)


def read_ply(path: str):
    """Minimal PLY reader for :func:`write_ply`'s output."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        has_color = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            dt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            verts = np.fromfile(f, dt, n_v)["xyz"]
        else:
            verts = np.fromfile(f, np.float32, n_v * 3).reshape(-1, 3)
        faces = None
        if n_f:
            dt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
            faces = np.fromfile(f, dt, n_f)["idx"]
    return verts, faces


class RunLogger:
    """Timestamped run directory with mesh/, misc/, ckpt/ and bak/."""

    def __init__(self, log_dir: str, exp_name: str = "run", config: dict | None = None):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.dir = os.path.join(log_dir, exp_name, stamp)
        for sub in ("mesh", "ckpt", "misc", "bak"):
            os.makedirs(os.path.join(self.dir, sub), exist_ok=True)
        if config is not None:
            with open(os.path.join(self.dir, "bak", "config.json"), "w") as f:
                json.dump(config, f, indent=2)

    def log_mesh(self, vertices, faces, name="final_mesh.ply"):
        write_ply(os.path.join(self.dir, "mesh", name), vertices, faces)

    def log_point_cloud(self, points, name="final_points.ply"):
        write_ply(os.path.join(self.dir, "misc", name), points)

    def log_numpy_data(self, data, name: str):
        """npy dump plus KITTI-format txt for (N, 4, 4) pose stacks."""
        data = np.asarray(data)
        np.save(os.path.join(self.dir, "misc", f"{name}.npy"), data)
        if data.ndim == 3 and data.shape[1:] == (4, 4):
            np.savetxt(os.path.join(self.dir, "misc", f"{name}.txt"),
                       data[:, :3, :].reshape(len(data), 12))

    def log_debug_data(self, blob, stamp):
        with open(os.path.join(self.dir, "misc", f"scene_data_{stamp}.pkl"), "wb") as f:
            pickle.dump(blob, f)

    def log_metrics(self, metrics: dict, name="metrics.json"):
        with open(os.path.join(self.dir, name), "w") as f:
            json.dump(metrics, f, indent=2, default=float)
