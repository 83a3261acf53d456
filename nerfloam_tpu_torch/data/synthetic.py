"""Analytic synthetic LiDAR world: ground plane + axis-aligned boxes.

Copy of nerfloam_tpu/data/synthetic.py (numpy only): the port imports nothing
of the JAX package.

The reference has no test fixtures at all (SURVEY §4); this module provides
the deterministic scenes our test pyramid and benchmark need: exact
ray-casting (ray/plane + ray/AABB), a spinning-LiDAR scan model, ground
truth poses, and surface samples for mesh F-score evaluation.
Pure numpy — host-side data generation only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticWorld(NamedTuple):
    boxes: np.ndarray   # (B, 2, 3) [min; max] corners
    ground_z: float

    def raycast(self, origins: np.ndarray, dirs: np.ndarray, max_depth: float):
        """Exact first-hit depths. origins/dirs (N, 3); returns (depth (N,),
        hit_ground (N,) bool). depth = inf where nothing hit within range."""
        N = origins.shape[0]
        t_best = np.full(N, np.inf)
        is_ground = np.zeros(N, bool)

        dz = dirs[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_g = (self.ground_z - origins[:, 2]) / dz
        ok = (dz < -1e-9) & (t_g > 1e-6)
        t_best = np.where(ok & (t_g < t_best), t_g, t_best)
        is_ground = np.where(ok & (t_g <= t_best), True, False)

        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, 1e12 * np.sign(dirs + 1e-30))
        for box in self.boxes:
            t1 = (box[0][None] - origins) * inv
            t2 = (box[1][None] - origins) * inv
            tmin = np.max(np.minimum(t1, t2), axis=-1)
            tmax = np.min(np.maximum(t1, t2), axis=-1)
            hit = (tmax > np.maximum(tmin, 1e-6)) & (tmin > 1e-6)
            better = hit & (tmin < t_best)
            t_best = np.where(better, tmin, t_best)
            is_ground = np.where(better, False, is_ground)

        t_best = np.where(t_best <= max_depth, t_best, np.inf)
        return t_best, is_ground


def make_world(seed: int = 0, n_boxes: int = 12, extent: float = 30.0) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_boxes, 3))
    centers[:, 2] = 0.0
    sizes = rng.uniform(1.0, 5.0, (n_boxes, 3))
    sizes[:, 2] = rng.uniform(2.0, 6.0, n_boxes)
    mins = centers - sizes / 2
    mins[:, 2] = 0.0
    maxs = centers + sizes / 2
    maxs[:, 2] = sizes[:, 2]
    # keep a corridor along the x axis clear for the trajectory
    keep = (np.abs(centers[:, 1]) > 4.0) | (mins[:, 0] > extent)
    return SyntheticWorld(boxes=np.stack([mins, maxs], 1)[keep], ground_z=0.0)


def lidar_dirs(n_beams: int = 16, n_azimuth: int = 360) -> np.ndarray:
    """Sensor-frame unit directions of a spinning LiDAR (velodyne-like)."""
    elev = np.deg2rad(np.linspace(-20.0, 3.0, n_beams))
    azim = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    e, a = np.meshgrid(elev, azim, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1)
    return d.reshape(-1, 3)


def straight_trajectory(n_frames: int, step: float = 0.5, height: float = 1.5,
                        yaw_rate: float = 0.0) -> np.ndarray:
    """GT poses (n, 4, 4): forward motion along +x with optional yaw."""
    poses = []
    x, y, yaw = 0.0, 0.0, 0.0
    for _ in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = [x, y, height]
        poses.append(T)
        x += step * c
        y += step * s
        yaw += yaw_rate
    return np.stack(poses)


def render_scan(
    world: SyntheticWorld,
    pose: np.ndarray,
    dirs_sensor: np.ndarray,
    max_depth: float = 40.0,
    min_depth: float = 1.0,
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Sensor-frame points + ground-cosine weights for one scan.

    Returns (points (M, 3), cos (M,)) — only rays that hit within range.
    cos for ground returns = |n_ground . dir| (what patchwork++ derived
    normals give the reference, src/dataset/kitti.py:64); 1.0 elsewhere.
    """
    R, t = pose[:3, :3], pose[:3, 3]
    wdirs = dirs_sensor @ R.T
    origins = np.broadcast_to(t, wdirs.shape)
    depth, is_ground = world.raycast(origins, wdirs, max_depth)
    hit = np.isfinite(depth) & (depth > min_depth)
    depth = depth[hit]
    if noise > 0 and rng is not None:
        depth = depth + rng.normal(0, noise, depth.shape)
    pts = dirs_sensor[hit] * depth[:, None]
    cos = np.where(is_ground[hit], np.abs(wdirs[hit, 2]), 1.0)
    return pts.astype(np.float32), cos.astype(np.float32)


def boxes_near(world: SyntheticWorld, center: np.ndarray, radius: float) -> SyntheticWorld:
    """World subset whose boxes can be hit within ``radius`` of ``center``
    (raycast cost is linear in boxes; a 500-frame corridor world carries
    hundreds, only dozens are in range of any one scan)."""
    if len(world.boxes) == 0:
        return world
    lo = world.boxes[:, 0] - center[None]
    hi = world.boxes[:, 1] - center[None]
    d = np.linalg.norm(np.maximum(np.maximum(lo, -hi), 0.0), axis=-1)
    return SyntheticWorld(boxes=world.boxes[d <= radius], ground_z=world.ground_z)


def kitti_trajectory(
    n_frames: int, seed: int = 0, max_yaw_per_frame: float = 0.05
) -> tuple[np.ndarray, np.ndarray]:
    """Segmented KITTI-statistics trajectory: urban straights, 90-degree
    turns, gentle curves, and a faster sparse highway stretch (KITTI 01
    style). Speeds 0.8-1.4 m/frame match KITTI's 10 Hz scan rate at
    30-50 km/h; per-frame yaw is capped at ``max_yaw_per_frame`` (~2.9 deg,
    a 10 Hz vehicle turn) — turn segments take however many frames that
    needs, shortening the straights, so short sequences still have sane
    dynamics. Returns (poses (N, 4, 4), urban (N,) bool)."""
    plan = [  # (fraction, step m/frame, total yaw change rad, urban)
        (0.16, 1.0, 0.0, True),
        (0.08, 0.8, -np.pi / 2, True),
        (0.13, 1.0, 0.0, True),
        (0.09, 1.0, 0.55, True),      # gentle curve
        (0.09, 1.0, -0.55, True),
        (0.21, 1.4, 0.0, False),      # highway
        (0.08, 0.9, np.pi / 2, False),
        (0.16, 1.0, 0.0, True),
    ]
    ks = [round(frac * n_frames) for frac, _, _, _ in plan]
    for i, (_, _, dyaw, _) in enumerate(plan):
        if dyaw:
            ks[i] = max(ks[i], int(np.ceil(abs(dyaw) / max_yaw_per_frame)))
    # absorb the excess in the straight segments, largest first
    excess = sum(ks) - n_frames
    order = sorted(
        (i for i, p in enumerate(plan) if p[2] == 0.0),
        key=lambda i: -ks[i],
    )
    while excess > 0 and order:
        for i in order:
            if excess <= 0:
                break
            take = min(ks[i] - 1, excess)
            ks[i] -= take
            excess -= take
        if all(ks[i] <= 1 for i in order):
            break
    poses, urban = [], []
    x, y, yaw = 0.0, 0.0, 0.0
    ramp_frames = 12  # vehicles start from rest (KITTI sequences do too):
    #                   velocity ramps over the first ~1.2 s so the tracker
    #                   has a motion prior before full speed
    for (frac, step, dyaw, is_urban), k in zip(plan, ks):
        if len(poses) >= n_frames:
            break
        rate = dyaw / max(k, 1)
        for _ in range(k):
            if len(poses) >= n_frames:
                break
            i = len(poses)
            ramp = min(1.0, (i + 1) / ramp_frames)
            c, s = np.cos(yaw), np.sin(yaw)
            T = np.eye(4)
            T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            T[:3, 3] = [x, y, 1.73]  # HDL-64E mount height
            poses.append(T)
            urban.append(is_urban)
            x += step * ramp * c
            y += step * ramp * s
            yaw += rate
    while len(poses) < n_frames:  # tiny n: pad by continuing straight
        T = poses[-1].copy()
        T[:3, 3] += T[:3, :3] @ np.array([1.0, 0.0, 0.0])
        poses.append(T)
        urban.append(True)
    return np.stack(poses), np.asarray(urban)


def make_kitti_world(
    poses: np.ndarray, urban: np.ndarray, seed: int = 0
) -> SyntheticWorld:
    """KITTI-statistics world built along a trajectory: building facades
    flanking urban road segments, parked cars, poles; sparse guardrails and
    occasional signs along highway segments; flat ground. All structures are
    placed relative to the local road heading, then any box encroaching on
    the driving corridor is dropped."""
    rng = np.random.default_rng(seed)
    boxes = []
    pos = poses[:, :3, 3]
    heading = poses[:, :3, :3] @ np.array([1.0, 0.0, 0.0])
    normal = np.stack([-heading[:, 1], heading[:, 0], np.zeros(len(pos))], -1)

    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pos, axis=0), axis=-1))])
    next_at = {"bldg": 0.0, "car": 3.0, "pole": 2.0, "clutter": 1.0, "rail": 0.0}
    for i in range(len(pos)):
        d = dist[i]
        p, nrm = pos[i], normal[i]
        if urban[i]:
            if d >= next_at["bldg"]:
                # shorter facades with gaps and staggered setbacks — facade
                # ends/corners are what constrain longitudinal motion (a
                # continuous wall corridor is a translation-degenerate scene
                # no real street exhibits)
                for side in (-1.0, 1.0):
                    if rng.uniform() < 0.75:  # empty lots / cross streets
                        off = rng.uniform(6.0, 13.0)
                        depth = rng.uniform(4.0, 10.0)
                        length = rng.uniform(5.0, 14.0)
                        h = rng.uniform(4.0, 14.0)
                        c = p + side * (off + depth / 2) * nrm + heading[i] * length / 2
                        half = np.array([
                            max(abs(heading[i, 0]) * length, abs(nrm[0]) * depth) / 2,
                            max(abs(heading[i, 1]) * length, abs(nrm[1]) * depth) / 2,
                            h / 2,
                        ])
                        half[:2] = np.maximum(half[:2], 1.5)
                        boxes.append([
                            [c[0] - half[0], c[1] - half[1], 0.0],
                            [c[0] + half[0], c[1] + half[1], h],
                        ])
                next_at["bldg"] = d + rng.uniform(8.0, 18.0)
            if d >= next_at["car"]:
                # parked cars both sides (urban KITTI streets are lined
                # with them — the dominant longitudinal texture); keep the
                # near edge outside the 2.6 m driving corridor or the
                # clearance filter below drops them
                for side in (-1.0, 1.0):
                    if rng.uniform() < 0.7:
                        hw = rng.uniform(1.0, 1.8)
                        c = p + side * (2.9 + hw + rng.uniform(0.0, 1.5)) * nrm
                        c = c + heading[i] * rng.uniform(-1.5, 1.5)
                        boxes.append([
                            [c[0] - hw, c[1] - hw, 0.0],
                            [c[0] + hw, c[1] + hw, rng.uniform(1.3, 1.8)],
                        ])
                next_at["car"] = d + rng.uniform(4.0, 11.0)
            if d >= next_at["pole"]:
                side = rng.choice([-1.0, 1.0])
                c = p + side * rng.uniform(4.5, 6.5) * nrm
                boxes.append([
                    [c[0] - 0.15, c[1] - 0.15, 0.0],
                    [c[0] + 0.15, c[1] + 0.15, rng.uniform(4.0, 7.0)],
                ])
                next_at["pole"] = d + rng.uniform(7.0, 14.0)
            if d >= next_at["clutter"]:
                # bins / bushes / hedges near the curb
                side = rng.choice([-1.0, 1.0])
                c = p + side * rng.uniform(4.0, 7.5) * nrm
                c = c + heading[i] * rng.uniform(-2.0, 2.0)
                hw = rng.uniform(0.3, 1.1)
                boxes.append([
                    [c[0] - hw, c[1] - hw, 0.0],
                    [c[0] + hw, c[1] + hw, rng.uniform(0.6, 1.6)],
                ])
                next_at["clutter"] = d + rng.uniform(3.0, 8.0)
        else:  # highway (KITTI 01 statistics): near-continuous guardrails,
            #   embankment vegetation, signs — sparse but never featureless
            if d >= next_at["rail"]:
                for side in (-1.0, 1.0):
                    c = p + side * 6.5 * nrm + heading[i] * 6.0
                    half = np.array([
                        max(abs(heading[i, 0]) * 12.0, abs(nrm[0]) * 0.3) / 2,
                        max(abs(heading[i, 1]) * 12.0, abs(nrm[1]) * 0.3) / 2,
                        0.4,
                    ])
                    half[:2] = np.maximum(half[:2], 0.15)
                    boxes.append([
                        [c[0] - half[0], c[1] - half[1], 0.0],
                        [c[0] + half[0], c[1] + half[1], 0.8],
                    ])
                if rng.uniform() < 0.3:
                    side = rng.choice([-1.0, 1.0])
                    c = p + side * 8.0 * nrm
                    boxes.append([
                        [c[0] - 1.5, c[1] - 0.2, 0.0],
                        [c[0] + 1.5, c[1] + 0.2, 6.0],
                    ])
                next_at["rail"] = d + rng.uniform(12.0, 16.0)
            if d >= next_at["clutter"]:
                # embankment bushes / reflector posts — the longitudinal
                # texture that keeps a highway trackable
                side = rng.choice([-1.0, 1.0])
                c = p + side * rng.uniform(8.0, 14.0) * nrm
                c = c + heading[i] * rng.uniform(-3.0, 3.0)
                hw = rng.uniform(0.4, 1.6)
                boxes.append([
                    [c[0] - hw, c[1] - hw, 0.0],
                    [c[0] + hw, c[1] + hw, rng.uniform(0.8, 2.5)],
                ])
                next_at["clutter"] = d + rng.uniform(6.0, 14.0)

    boxes = np.asarray(boxes, np.float64).reshape(-1, 2, 3)
    # drop anything encroaching on the driving corridor (2.6 m of any pose)
    clear = np.ones(len(boxes), bool)
    for i, b in enumerate(boxes):
        q = np.clip(pos, b[0], b[1])
        if np.min(np.linalg.norm(q - pos, axis=-1)) < 2.6:
            clear[i] = False
    return SyntheticWorld(boxes=boxes[clear], ground_z=0.0)


def hdl64_dirs(n_azimuth: int = 2048) -> np.ndarray:
    """Velodyne HDL-64E beam pattern (KITTI): 64 beams, -24.8 to +2 deg."""
    elev = np.deg2rad(np.linspace(-24.8, 2.0, 64))
    azim = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    e, a = np.meshgrid(elev, azim, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1)
    return d.reshape(-1, 3)


def corridor_surface_samples(
    world: SyntheticWorld,
    traj_xyz: np.ndarray,
    n: int = 200000,
    radius: float = 30.0,
    seed: int = 1,
) -> np.ndarray:
    """GT surface samples restricted to the observed corridor around a long
    trajectory (the replica-world analog of a survey-grade GT cloud: only
    what a scan could see is fair game for completeness)."""
    rng = np.random.default_rng(seed)
    # ground: random trajectory anchor + disc offset
    k = n // 2
    anchors = traj_xyz[rng.integers(0, len(traj_xyz), k)]
    ang = rng.uniform(0, 2 * np.pi, k)
    rad = radius * np.sqrt(rng.uniform(0, 1, k))
    ground = np.stack(
        [anchors[:, 0] + rad * np.cos(ang), anchors[:, 1] + rad * np.sin(ang),
         np.full(k, world.ground_z)], -1,
    )
    pts = [ground]
    if len(world.boxes):
        # box faces, area-weighted, only boxes near the corridor
        centers = 0.5 * (world.boxes[:, 0] + world.boxes[:, 1])
        d = np.min(
            np.linalg.norm(centers[:, None, :2] - traj_xyz[None, ::5, :2], axis=-1),
            axis=1,
        )
        near = world.boxes[d < radius]
        sizes = near[:, 1] - near[:, 0]
        areas = 2 * (
            sizes[:, 0] * sizes[:, 2] + sizes[:, 1] * sizes[:, 2]
            + sizes[:, 0] * sizes[:, 1]
        )
        probs = areas / areas.sum()
        pick = rng.choice(len(near), n - k, p=probs)
        for bi in np.unique(pick):
            m = int((pick == bi).sum())
            box = near[bi]
            size = box[1] - box[0]
            face_area = np.array([
                size[1] * size[2], size[0] * size[2], size[0] * size[1],
            ]).repeat(2)
            fpick = rng.choice(6, m, p=face_area / face_area.sum())
            p = rng.uniform(box[0], box[1], (m, 3))
            for f in range(6):
                sel = fpick == f
                p[sel, f // 2] = box[f % 2][f // 2]
            pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def surface_samples(world: SyntheticWorld, n: int = 20000, extent: float = 35.0,
                    seed: int = 1) -> np.ndarray:
    """Uniform samples on the world surface (ground + box faces) for mesh
    accuracy/completeness evaluation (SHINE-mapping-protocol style)."""
    rng = np.random.default_rng(seed)
    pts = [np.stack([rng.uniform(-extent, extent, n // 2),
                     rng.uniform(-extent, extent, n // 2),
                     np.full(n // 2, world.ground_z)], -1)]
    per_box = max(1, (n // 2) // max(len(world.boxes), 1))
    for box in world.boxes:
        size = box[1] - box[0]
        areas = np.array([size[1] * size[2], size[0] * size[2], size[0] * size[1]])
        for axis in range(3):
            k = max(1, int(per_box * areas[axis] / areas.sum() / 2))
            for side in range(2):
                p = rng.uniform(box[0], box[1], (k, 3))
                p[:, axis] = box[side][axis]
                pts.append(p)
    return np.concatenate(pts).astype(np.float32)
