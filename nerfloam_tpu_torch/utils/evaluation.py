"""Trajectory metrics (port of nerfloam_tpu/utils/evaluation.py:15-50):
ATE RMSE, raw or after an SE(3) Umeyama alignment. Numpy only; the mesh
metrics wait for the meshing slice."""

from __future__ import annotations

import numpy as np


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """ATE RMSE between (N, 4, 4) or (N, 3) trajectories."""
    p_est = est[:, :3, 3] if est.ndim == 3 else est
    p_gt = gt[:, :3, 3] if gt.ndim == 3 else gt
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    if align and n >= 3:
        p_est = umeyama_align(p_est, p_gt)
    return float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=-1))))


def umeyama_transform(src: np.ndarray, dst: np.ndarray):
    """SE(3) (no scale) Umeyama alignment of src onto dst: returns (R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def umeyama_align(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """src moved onto dst by :func:`umeyama_transform`."""
    R, t = umeyama_transform(src, dst)
    return src @ R.T + t
