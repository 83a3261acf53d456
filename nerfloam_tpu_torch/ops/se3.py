"""Differentiable SE(3) pose parameterization (port of nerfloam_tpu/ops/se3.py).

pose6 = [t (3), w (3)]: raw translation plus axis-angle rotation,
R = exp([w]x) in closed form with a grad-safe small-angle branch. All
matmuls run in true float32 (TF32 is off, see the package __init__).
"""

from __future__ import annotations

import torch

from nerfloam_tpu_torch.ops.ieee import const, div, norm3

_SMALL = 1e-8  # theta^2 switch point for the series branches


def skew(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]x for w (..., 3) -> (..., 3, 3)."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([o, -w2, w1], dim=-1),
            torch.stack([w2, o, -w0], dim=-1),
            torch.stack([-w1, w0, o], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A = sin(t)/t and B = (1-cos(t))/t^2 with a grad-safe small-angle
    branch: the value fed to sqrt is clamped on the series side so the
    branch not taken stays finite and differentiable. The series terms
    divide as JAX does (one IEEE division each, ``ieee.div``)."""
    small = theta2 < _SMALL
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    a_exact = torch.sin(theta) / theta
    b_exact = (1.0 - torch.cos(theta)) / safe_t2
    t4 = theta2 * theta2
    a_series = 1.0 - div(theta2, 6.0) + div(t4, 120.0)
    b_series = 0.5 - div(theta2, 24.0) + div(t4, 720.0)
    return torch.where(small, a_series, a_exact), torch.where(small, b_series, b_exact)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp([w]x) for w (..., 3) -> rotation matrices (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b = _sinc_coeffs(theta2)
    wx = skew(w)
    wx2 = torch.matmul(wx, wx)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * wx + b[..., None, None] * wx2


def log_so3(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Matrix log: rotation (..., 3, 3) -> axis-angle (..., 3), by Shepperd's
    quaternion extraction; angle in [0, pi]."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    r21 = R[..., 2, 1] - R[..., 1, 2]
    r02 = R[..., 0, 2] - R[..., 2, 0]
    r10 = R[..., 1, 0] - R[..., 0, 1]
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    sw = 2.0 * torch.sqrt(torch.clamp(tw, min=eps))
    sx = 2.0 * torch.sqrt(torch.clamp(tx, min=eps))
    sy = 2.0 * torch.sqrt(torch.clamp(ty, min=eps))
    sz = 2.0 * torch.sqrt(torch.clamp(tz, min=eps))
    qw = torch.stack([sw * 0.25, r21 / sw, r02 / sw, r10 / sw], dim=-1)
    qx = torch.stack([r21 / sx, sx * 0.25, s01 / sx, s02 / sx], dim=-1)
    qy = torch.stack([r02 / sy, s01 / sy, sy * 0.25, s12 / sy], dim=-1)
    qz = torch.stack([r10 / sz, s02 / sz, s12 / sz, sz * 0.25], dim=-1)
    idx = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)[..., None]
    q = torch.where(idx == 0, qw, torch.where(idx == 1, qx, torch.where(idx == 2, qy, qz)))
    q = q * torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    vec = q[..., 1:4]
    n = norm3(vec.contiguous())
    theta = 2.0 * torch.atan2(n, q[..., 0])
    small = n < 1e-6
    scale = torch.where(small, torch.full_like(n, 2.0), theta / torch.where(small, torch.ones_like(n), n))
    return vec * scale[..., None]


def pose_rotation(p6: torch.Tensor) -> torch.Tensor:
    return exp_so3(p6[..., 3:6])


def pose_translation(p6: torch.Tensor) -> torch.Tensor:
    return p6[..., 0:3]


def pose_matrix(p6: torch.Tensor) -> torch.Tensor:
    """pose6 (..., 6) -> homogeneous transform (..., 4, 4)."""
    R = pose_rotation(p6)
    t = pose_translation(p6)
    bottom = const(((0.0, 0.0, 0.0, 1.0),), p6.dtype, p6.device).expand(p6.shape[:-1] + (1, 4))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def pose_from_matrix(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> pose6 (..., 6)."""
    return torch.cat([T[..., :3, 3], log_so3(T[..., :3, :3])], dim=-1)


def transform_points(p6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R @ p + t for pts (..., N, 3) with pose6 (..., 6)."""
    R = pose_rotation(p6)
    return torch.matmul(pts, R.transpose(-1, -2)) + pose_translation(p6)[..., None, :]


def rotate_dirs(p6: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors by the pose rotation (no translation)."""
    return torch.matmul(dirs, pose_rotation(p6).transpose(-1, -2))


def inv_transform_points(p6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R^T @ (p - t)."""
    return torch.matmul(pts - pose_translation(p6)[..., None, :], pose_rotation(p6))


def compose_matrices(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, B)


def invert_matrix(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -torch.matmul(Rt, T[..., :3, 3:4])
    top = torch.cat([Rt, t], dim=-1)
    return torch.cat([top, T[..., 3:4, :]], dim=-2)
