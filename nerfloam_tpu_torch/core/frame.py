"""Host-side frame containers with static-shape padding (port of
nerfloam_tpu/core/frame.py:22-174, which imports jax). Point buffers are
padded to a static size and uploaded once to an explicit device, through
``upload``: a CUDA upload waits for nothing queued on the card."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def upload(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (numpy, list or scalar) as a tensor on ``device``. A
    CUDA upload goes through pinned memory with ``non_blocking=True``: a
    copy from pageable memory waits for all the work queued on the stream
    first, which under ``defer_sync`` is the whole frame in flight
    (PyTorch's pinned allocator keeps the staging block until the copy has
    run). A CPU upload is ``torch.as_tensor``."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    host = torch.as_tensor(np.asarray(a), dtype=dtype)
    return host.pin_memory().to(device, non_blocking=True)


def pose6_from_matrix_np(T: np.ndarray) -> np.ndarray:
    """Numpy pose6 from a homogeneous matrix (quaternion log, the math of
    ops/se3.log_so3)."""
    R = np.asarray(T, np.float64)[:3, :3]
    K = np.array([
        1 + R[0, 0] + R[1, 1] + R[2, 2],
        1 + R[0, 0] - R[1, 1] - R[2, 2],
        1 - R[0, 0] + R[1, 1] - R[2, 2],
        1 - R[0, 0] - R[1, 1] + R[2, 2],
    ])
    i = int(np.argmax(K))
    s = 2.0 * np.sqrt(max(K[i], 1e-12))
    r21, r02, r10 = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s01, s02, s12 = R[0, 1] + R[1, 0], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1]
    q = [
        np.array([s / 4, r21 / s, r02 / s, r10 / s]),
        np.array([r21 / s, s / 4, s01 / s, s02 / s]),
        np.array([r02 / s, s01 / s, s / 4, s12 / s]),
        np.array([r10 / s, s02 / s, s12 / s, s / 4]),
    ][i]
    if q[0] < 0:
        q = -q
    n = np.linalg.norm(q[1:])
    theta = 2.0 * np.arctan2(n, q[0])
    out = np.empty(6, np.float32)
    out[:3] = np.asarray(T, np.float64)[:3, 3]
    out[3:] = q[1:] * (2.0 if n < 1e-9 else theta / n)
    return out


def matrix_from_pose6_np(p6: np.ndarray) -> np.ndarray:
    """Numpy Rodrigues (the math of ops/se3.exp_so3)."""
    p6 = np.asarray(p6, np.float64)
    w = p6[3:6]
    theta2 = float(w @ w)
    if theta2 < 1e-12:
        A, B = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    else:
        theta = np.sqrt(theta2)
        A, B = np.sin(theta) / theta, (1.0 - np.cos(theta)) / theta2
    wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = (np.eye(3) + A * wx + B * (wx @ wx)).astype(np.float32)
    T[:3, 3] = p6[:3].astype(np.float32)
    return T


@dataclass(eq=False)
class Frame:
    index: int
    points: np.ndarray       # (P, 3) float32, zero-padded
    points_cos: np.ndarray   # (P,) float32
    valid: np.ndarray        # (P,) bool
    n_points: int
    pose6: np.ndarray        # (6,) float32 world pose [t, w]
    rel_pose: np.ndarray | None = None
    has_gt_pose: bool = False
    hit_ratio: float = 0.0
    _dev: tuple | None = None  # (device, points, cos, valid) uploaded once

    def device_arrays(self, device):
        """Copies of the immutable point buffers on ``device``, uploaded once
        (``upload``)."""
        device = torch.device(device)
        if self._dev is None or self._dev[0] != device:
            self._dev = (device, upload(self.points, device), upload(self.points_cos, device),
                         upload(self.valid, device))
        return self._dev[1:]

    @classmethod
    def from_raw(cls, index: int, points: np.ndarray, cos: np.ndarray, pose, pad: int,
                 has_gt_pose: bool = False) -> "Frame":
        n = min(len(points), pad)
        if len(points) > pad:  # keep a uniform subset if the scan overflows
            sel = np.random.default_rng(index).choice(len(points), pad, replace=False)
            points, cos = points[sel], cos[sel]
            n = pad
        P = np.zeros((pad, 3), np.float32)
        C = np.ones((pad,), np.float32)
        V = np.zeros((pad,), bool)
        P[:n] = points[:n]
        C[:n] = cos[:n]
        V[:n] = True
        pose6 = pose6_from_matrix_np(pose) if pose is not None else np.zeros(6, np.float32)
        return cls(index, P, C, V, n, pose6.astype(np.float32), has_gt_pose=has_gt_pose)

    def pose_matrix(self) -> np.ndarray:
        return matrix_from_pose6_np(self.pose6)

    def cropped(self, key_distance: float, pad: int) -> "Frame":
        """Keyframe crop: |x|,|y|,|z| < key_distance + 0.01 (sensor frame)."""
        vd = key_distance + 0.01
        m = self.valid & np.all(np.abs(self.points) < vd, axis=-1)
        f = Frame.from_raw(self.index, self.points[m], self.points_cos[m], None, pad)
        f.pose6 = self.pose6.copy()
        f.has_gt_pose = self.has_gt_pose
        return f

    def without_back_points(self, key_distance: float) -> "Frame":
        """remove_back_points (mapping.py:235-255; JAX core/frame.py:151-174):
        the valid mask without the far points opposite the motion
        direction, cos(angle to -motion_xy) >= 0.7 beyond key_distance. The
        motion is ``rel_pose``'s translation in xy, (1, 0) while it is None."""
        if self.rel_pose is None:
            rel_xy = np.array([1.0, 0.0])
        else:
            rel_xy = np.array([self.rel_pose[0, 3], self.rel_pose[1, 3]])
        pts_xy = self.points[:, :2]
        norm = np.linalg.norm(pts_xy, axis=-1) * (np.linalg.norm(rel_xy) + 1e-12)
        cos_back = np.sum(-pts_xy * rel_xy, axis=-1) / np.maximum(norm, 1e-12)
        dist = np.linalg.norm(self.points, axis=-1)
        remove = (cos_back >= 0.7) & (dist > key_distance)
        valid = self.valid & ~remove
        return Frame(self.index, self.points.copy(), self.points_cos.copy(), valid,
                     int(valid.sum()), self.pose6.copy(), self.rel_pose, self.has_gt_pose)
