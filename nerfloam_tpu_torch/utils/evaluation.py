"""Trajectory and mesh quality metrics (port of
nerfloam_tpu/utils/evaluation.py): ATE RMSE, raw or after an SE(3) Umeyama
alignment, and mesh accuracy / completeness / Chamfer-L1 / F-score against
ground-truth surface samples (the SHINE-mapping protocol quantities), with
the observed-surface ground truth of scripts/eval_replica.py. Numpy and
scipy only."""

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


def _nn_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Nearest-neighbour distance from each point of a to the set b."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(b).query(a, workers=-1)
    return d


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int = 100000,
                        seed: int = 0) -> np.ndarray:
    """Uniform area-weighted samples on a triangle mesh."""
    if len(faces) == 0:
        return verts[:0]
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    a = tri[:, 1] - tri[:, 0]
    b = tri[:, 2] - tri[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)
    probs = area / max(area.sum(), 1e-12)
    pick = rng.choice(len(faces), n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[pick]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])).astype(np.float32)


def crop_to_observed(gt_pts: np.ndarray, obs_pts: np.ndarray, radius: float = 0.5) -> np.ndarray:
    """Crop a GT cloud to the region observed by ``obs_pts``: a GT point is
    kept iff some observed point lies in its 3x3x3 neighbourhood of cells of
    size ``radius`` (keeps every point within radius, drops everything
    farther than ~1.73 radius), so completeness is not charged for surfaces
    the sensor never saw."""
    cell = float(radius)
    occ = np.unique(np.floor(obs_pts[:, :3] / cell).astype(np.int64), axis=0)

    def key(c):  # 3 int coords in one int64 (21 bits/axis, signed offset)
        c = c + (1 << 20)
        return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]

    okeys = np.sort(key(occ))
    gcell = np.floor(gt_pts[:, :3] / cell).astype(np.int64)
    keep = np.zeros(len(gt_pts), dtype=bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if keep.all():
                    break
                k = key(gcell + np.array([dx, dy, dz], dtype=np.int64))
                idx = np.minimum(np.searchsorted(okeys, k), len(okeys) - 1)
                keep |= okeys[idx] == k
    return gt_pts[keep]


def mesh_metrics(mesh_samples: np.ndarray, gt_samples: np.ndarray, f_threshold: float = 0.1,
                 trunc_dist: float = 2.0) -> dict:
    """SHINE-protocol style metrics (meters). f_threshold = 10 cm default."""
    d_acc = _nn_dist(mesh_samples, gt_samples)
    d_comp = _nn_dist(gt_samples, mesh_samples)
    d_acc_t = np.minimum(d_acc, trunc_dist)
    d_comp_t = np.minimum(d_comp, trunc_dist)
    precision = float((d_acc < f_threshold).mean())
    recall = float((d_comp < f_threshold).mean())
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy_m": float(d_acc_t.mean()),
        "completeness_m": float(d_comp_t.mean()),
        "chamfer_l1_m": float(0.5 * (d_acc_t.mean() + d_comp_t.mean())),
        "precision": precision,
        "recall": recall,
        "f_score": float(f),
    }


def observed_gt_cloud(dataset, stride: int = 4, per_frame: int = 6000, voxel: float = 0.05,
                      seed: int = 0) -> np.ndarray:
    """Observed-surface GT (scripts/eval_replica.py:33-55): the dataset's
    own scan points at GT poses, accumulated and voxel-downsampled. Surfaces
    no scan ever saw are not legitimate completeness targets for a LiDAR
    map."""
    from nerfloam_tpu_torch.map.mesher import downsample_points

    rng = np.random.default_rng(seed)
    gt = dataset.gt_trajectory()
    clouds = []
    for i in range(0, len(dataset), stride):
        _, pts, _, _ = dataset[i]
        if len(pts) > per_frame:
            pts = pts[rng.choice(len(pts), per_frame, replace=False)]
        T = gt[i]
        clouds.append(pts @ T[:3, :3].T + T[:3, 3])
    return downsample_points(np.concatenate(clouds).astype(np.float32), voxel)


def score_mesh(verts, faces, est_poses, gt_poses, dataset, n_samples: int = 200000,
               f_threshold: float = 0.2) -> dict:
    """The replica gate's mesh protocol (scripts/eval_replica.py:130-141):
    area-weighted samples of the (cleaned) mesh, brought into the GT frame
    by the trajectory's Umeyama transform, scored against the observed
    GT cloud."""
    mesh_pts = sample_mesh_surface(verts, faces, n_samples)
    R, t = umeyama_transform(np.asarray(est_poses)[:, :3, 3], np.asarray(gt_poses)[:, :3, 3])
    return mesh_metrics(mesh_pts @ R.T + t, observed_gt_cloud(dataset), f_threshold=f_threshold)
