"""Ground segmentation with per-point normal cosines ("patchwork-lite").

Copy of nerfloam_tpu/data/ground.py (numpy only): the port imports nothing
of the JAX package.

The reference imports the external patchwork++ C++ library (NeRF-LOAM
src/dataset/kitti.py:10-16) but consumes only two signals from it
(kitti.py:56-68): the ground/non-ground split and, for ground points, the
cosine |n . ray_dir| between the local ground-plane normal and the ray —
used to widen the SDF truncation band for grazing returns (criterion.py:
34-35). This module reproduces exactly that signal with a vectorized
numpy concentric-zone model (patchwork's CZM): polar cells, lowest-point
seeding, iterated PCA plane fits (R-GPF), uprightness + elevation tests.
"""

from __future__ import annotations

import numpy as np


def _plane_fit(pts: np.ndarray):
    """PCA plane through points: returns (normal (3,), d, mean) with unit
    normal oriented +z."""
    mean = pts.mean(0)
    q = pts - mean
    cov = q.T @ q / max(len(pts), 1)
    w, v = np.linalg.eigh(cov)
    n = v[:, 0]
    if n[2] < 0:
        n = -n
    return n, -float(n @ mean), mean


def segment_ground(
    points: np.ndarray,
    n_rings: int = 8,
    n_sectors: int = 16,
    min_range: float = 1.0,
    max_range: float = 80.0,
    seed_quantile: float = 0.15,
    dist_th: float = 0.2,
    uprightness_th: float = 0.85,
    n_iters: int = 3,
    sensor_height: float = 1.7,
):
    """Split a scan into ground/non-ground and compute ground cosines.

    points: (N, 3) sensor-frame. Returns (ground_mask (N,) bool,
    cos (N,) float32 — |n_cell . dir| for ground points, 1.0 elsewhere).
    """
    N = len(points)
    ground = np.zeros(N, bool)
    cos = np.ones(N, np.float32)
    if N == 0:
        return ground, cos

    rng_xy = np.linalg.norm(points[:, :2], axis=-1)
    az = np.arctan2(points[:, 1], points[:, 0])  # [-pi, pi]

    ring_edges = np.geomspace(min_range, max_range, n_rings + 1)
    ring = np.clip(np.searchsorted(ring_edges, rng_xy) - 1, 0, n_rings - 1)
    sector = np.clip(
        ((az + np.pi) / (2 * np.pi) * n_sectors).astype(int), 0, n_sectors - 1
    )
    cell = ring * n_sectors + sector

    dirs = points / (np.linalg.norm(points, axis=-1, keepdims=True) + 1e-12)

    for c in np.unique(cell):
        idx = np.nonzero(cell == c)[0]
        if len(idx) < 8:
            continue
        pts = points[idx]
        z = pts[:, 2]
        # seed with the lowest quantile of the cell (reject far-below-ground
        # outliers like patchwork's RNR by bounding vs sensor height)
        z_seed = np.quantile(z, seed_quantile)
        seeds = (z <= z_seed + 0.15) & (z > -sensor_height - 1.5)
        if seeds.sum() < 3:
            continue
        sel = seeds
        n = None
        for _ in range(n_iters):
            n, d, _ = _plane_fit(pts[sel])
            dist = np.abs(pts @ n + d)
            sel = dist < dist_th
            if sel.sum() < 3:
                n = None
                break
        if n is None or n[2] < uprightness_th:
            continue
        inliers = idx[sel]
        ground[inliers] = True
        cos[inliers] = np.abs(dirs[inliers] @ n).astype(np.float32)
    return ground, cos


def points_with_cos(points: np.ndarray, enable: bool = True):
    """Convenience: (points, cos) in the dataset __getitem__ contract
    (ground points first, like kitti.py:67-68 concatenation — order is
    irrelevant downstream; we keep the input order)."""
    if not enable or len(points) == 0:
        return points, np.ones(len(points), np.float32)
    _, cos = segment_ground(points)
    return points, cos
