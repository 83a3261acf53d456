"""Frame-to-map tracking, Gauss-Newton / LM path (port of
nerfloam_tpu/core/tracking.py:40-88, 89-346, 374-381, single device).

Per iteration: K1 places the samples and interpolates their features at
the iteration's pose, the decoder runs forward and backward to d sdf /
d feats, and K2 (with the packed gradient off) turns that into the spatial
gradient g per sample. The 6x6 normal equations (K3 in the roadmap) and
the LM solve stay in torch this slice. The loop never reads a value back
to the host: shapes are static and ``torch.linalg.solve_ex`` skips the
error check that would synchronise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfloam_tpu_torch.core.render import hits_field_bwd, hits_field_fwd
from nerfloam_tpu_torch.map.voxel_map import MapConfig, MapState
from nerfloam_tpu_torch.models.decoder import decoder_apply
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.raycast import RaycastConfig, build_hit_table, uniform_jitter
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices


class TrackParams(NamedTuple):
    n_rays: int
    num_iterations: int
    truncation: float
    max_depth: float
    fs_weight: float
    sdf_weight: float
    compute_dtype: str = "float32"


class TrackResult(NamedTuple):
    pose: torch.Tensor       # (6,)
    hit_count: torch.Tensor  # () int: hit rays at the last iteration
    loss: torch.Tensor       # () last-iteration loss


def t_cap_for(points: torch.Tensor, cos: torch.Tensor, truncation: float, max_depth: float):
    """Per-ray useful range: measured distance + cosine-widened band."""
    d = torch.linalg.norm(points, dim=-1)
    band = truncation / torch.clamp(cos, min=0.05)
    return torch.clamp(d + band + 0.5, max=max_depth)


def _ray_dirs(pts: torch.Tensor) -> torch.Tensor:
    return pts / (torch.linalg.norm(pts, dim=-1, keepdim=True) + 1e-8)


def gn_system(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp: TrackParams):
    """Residuals, count-balanced weights and the 6x6 normal equations
    (tracking.py:217-244, 300-315), with the band target sdf = 0 (the
    bias transfer is the quality stack's). Returns (H, b, loss)."""
    T = tp.truncation
    zc = z * pcos[:, None]
    d = d_meas[:, None]
    front = (zc < (d - T)) & vmask
    band = vmask & ~front & ~(zc > (d + T)) & depth_ok[:, None]
    num_fs = front.sum()
    num_sdf = band.sum()
    tot = torch.clamp(num_fs + num_sdf, min=1).to(torch.float32)
    w_fs = tp.fs_weight * (1.0 - num_fs / tot)
    w_sdf = tp.sdf_weight * (1.0 - num_sdf / tot)
    r = torch.where(front, sdf - 1.0, (zc + sdf * T) - d)
    w = torch.where(front, w_fs, w_sdf) * (front | band)
    jscale = torch.where(front, 1.0, T)
    q = xyz - t_pos
    gj = g * jscale[..., None]
    J = torch.cat([gj, torch.linalg.cross(q, gj, dim=-1)], -1)
    Jw = J * w[..., None]
    H = torch.einsum("nmi,nmj->ij", Jw, J)
    b = torch.einsum("nmi,nm->i", Jw, r)
    return H, b, torch.sum(w * r * r)


def lm_update(pose6, H, b, lam):
    """Damped solve, trust region (0.5 m / 0.1 rad), left-multiplied update."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    Hd = H + lam * torch.diag(torch.diag(H)) + 1e-6 * eye
    delta = -torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
    dt, dth = delta[:3], delta[3:]
    dt = dt * torch.clamp(0.5 / (torch.linalg.norm(dt) + 1e-12), max=1.0)
    dth = dth * torch.clamp(0.1 / (torch.linalg.norm(dth) + 1e-12), max=1.0)
    R_new = se3.compose_matrices(se3.exp_so3(dth), se3.pose_rotation(pose6))
    return torch.cat([pose6[:3] + dt, se3.log_so3(R_new)])


def field_and_grad(decoder_params, feats, xyz, aid, valid, packed, voxel_size, compute_dtype):
    """sdf and d sdf / d xyz per sample: decoder forward and backward to
    d sdf / d feats in torch, then K2 with the packed gradient off."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        sdf = decoder_apply(decoder_params, f, compute_dtype)[..., 0]
        (dfeats,) = torch.autograd.grad(sdf.sum(), f)
    g, _ = hits_field_bwd(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked=False)
    return sdf.detach(), g


@torch.no_grad()
def track_frame_gn(map_state: MapState, map_cfg: MapConfig, rc: RaycastConfig, tp: TrackParams,
                   decoder_params, init_pose, points, points_cos, points_valid,
                   generator: torch.Generator | None = None) -> TrackResult:
    """LM pose tracking on the truncated-SDF residuals over one frame's
    (padded) points."""
    if rc.sampler != "hits":
        raise NotImplementedError("the grid sampler is not ported yet (ROADMAP queue 1, item 11)")
    dev = points.device
    compute_dtype = getattr(torch, tp.compute_dtype)
    vs = map_cfg.voxel_size
    packed = map_state.packed
    ridx, rvalid = sample_ray_indices(points_valid, tp.n_rays, generator)
    pts = points[ridx]
    pcos = points_cos[ridx]
    dirs = _ray_dirs(pts)
    t_cap = t_cap_for(pts, pcos, tp.truncation, tp.max_depth)
    d_meas = torch.linalg.norm(pts, dim=-1) * pcos
    depth_ok = (d_meas > 0.0) & (d_meas < tp.max_depth)

    wdirs0 = se3.rotate_dirs(init_pose, dirs)
    origin0 = se3.pose_translation(init_pose).expand_as(wdirs0)
    ht0 = build_hit_table(map_state, map_cfg, rc, origin0, wdirs0, t_cap)

    pose6 = init_pose
    lam = 1e-2
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for it in range(tp.num_iterations):
        wdirs = se3.rotate_dirs(pose6, dirs)
        t_pos = se3.pose_translation(pose6)
        origin = t_pos.expand_as(wdirs)
        u = uniform_jitter((tp.n_rays, rc.n_samples), generator, dev)
        z, valid, aid, xyz, feats = hits_field_fwd(ht0, u, origin, wdirs, packed, vs)
        vmask = valid & rvalid[:, None]
        sdf, g = field_and_grad(decoder_params, feats, xyz, aid, valid, packed, vs, compute_dtype)
        H, b, loss = gn_system(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp)
        pose6 = lm_update(pose6, H, b, lam)
        hits = (ht0.ray_mask & rvalid).sum()
    pose6 = torch.where(hits > 0, pose6, init_pose)
    return TrackResult(pose6, hits, loss)
