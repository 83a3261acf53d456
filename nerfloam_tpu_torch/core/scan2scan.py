"""Scan-to-scan projective point-to-plane odometry constraint (port of
nerfloam_tpu/core/scan2scan.py): a map-independent relative-motion
observation added to the GN tracker's normal equations
(``tpu_specs.s2s_weight > 0``).

The previous scan is rasterized once per frame into a fixed-shape spherical
range image with per-pixel world-frame surface points (the mean of the
pixel's points) and central-difference normals: K11a ``build_prev_scan``.
Each tracker iteration projects the current ray subset into the previous
sensor frame (one gather per point instead of a nearest-neighbour search),
gates by depth agreement and accumulates Huber-weighted point-to-plane
residuals r = n_w . (p_w(pose) - q_w) into a 6x6 system with the
left-perturbation Jacobian J = [n_w, (p_w - t) x n_w]: K11b ``s2s_system``.
The tracker adds it to the SDF term's system before the LM solve.

Both kernels live in csrc/scan2scan.cu; the plain twins beside the wrappers
run on CPU tensors and repeat the kernels' arithmetic one rounded operation
at a time (no matrix products, whose summation order the library picks),
so bins, pixels and validity agree exactly on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.map.voxel_map import _add_in_order, div
from nerfloam_tpu_torch.ops import se3

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
build_prev_scan_launches = 0  # K11a
s2s_system_launches = 0       # K11b


class Scan2ScanParams(NamedTuple):
    """Static configuration (part of TrackParams)."""

    weight: float = 0.0      # per-residual weight in the GN system; 0 = off.
    #   The SDF term's Hessian mass is ~1e4-1e5; N~2048 s2s residuals at
    #   weight w contribute ~2048*w, so w in the 5-50 range makes the terms
    #   comparable
    n_elev: int = 64         # range-image elevation bins (~beam count)
    n_az: int = 1024         # range-image azimuth bins
    gate_dist: float = 1.0   # drop correspondences with |r| beyond this (m)
    huber: float = 0.2       # Huber transition for the residual (m)
    min_depth: float = 2.0
    max_depth: float = 60.0


class PrevScan(NamedTuple):
    """Rasterized previous scan (world frame), built once per frame."""

    q_w: torch.Tensor        # (B, A, 3) per-pixel surface point, world frame
    n_w: torch.Tensor        # (B, A, 3) per-pixel unit normal, world frame
    pix_valid: torch.Tensor  # (B, A) bool: point and normal valid
    depth: torch.Tensor      # (B, A) per-pixel range (previous sensor frame)
    pose6: torch.Tensor      # (6,) previous frame pose
    elev_min: torch.Tensor   # () scan elevation span (radians)
    elev_max: torch.Tensor   # ()


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v for v (..., 3): each row of R times v, summed left to right."""
    return torch.stack([_dot3(v, R[r]) for r in range(3)], -1)


def _angles(pts: torch.Tensor):
    """(..., 3) sensor-frame points -> (azimuth, elevation, range)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    d = _norm3(pts)
    az = torch.atan2(y, x)                                  # [-pi, pi]
    horiz = torch.sqrt(x * x + y * y)
    return az, torch.atan2(z, horiz + 1e-12), d


def _bin(v: torch.Tensor, n: int) -> torch.Tensor:
    """clip(int(v), 0, n - 1); the float is clamped first so the cast is
    defined for any value."""
    return torch.clamp(torch.clamp(v, -1.0, float(n)).to(torch.int32), 0, n - 1)


def _elev_bin_f(elev, e_min, e_max, B: int):
    span = torch.clamp(e_max - e_min, min=1e-3)
    return (elev - e_min) / span * (B - 1)


def _az_bin(az, A: int):
    return _bin(div(az + math.pi, 2 * math.pi) * A, A)


def build_prev_scan_plain(sp: Scan2ScanParams, points, valid, pose6) -> PrevScan:
    """Plain torch twin of K11a (scan2scan.py:98-155). The per-pixel sums
    add their points in ascending point index (``_add_in_order``), as a
    sequential scatter-add does."""
    B, A = sp.n_elev, sp.n_az
    dev = points.device
    points = points.float()
    az, elev, d = _angles(points)
    ok = valid & (d > sp.min_depth) & (d < sp.max_depth)
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    e_min = torch.min(torch.where(ok, elev, big)) if points.shape[0] else big
    e_max = torch.max(torch.where(ok, elev, -big)) if points.shape[0] else -big
    pix = _bin(_elev_bin_f(elev, e_min, e_max, B), B) * A + _az_bin(az, A)
    total = B * A
    dest = torch.where(ok, pix, total)
    psum = _add_in_order(torch.zeros((total, 3), device=dev), dest, points)
    cnt = _add_in_order(torch.zeros((total,), device=dev), dest, torch.ones_like(d))
    pts3 = psum / torch.clamp(cnt, min=1.0)[:, None]
    P_img = pts3.reshape(B, A, 3)
    V_img = (cnt > 0).reshape(B, A)

    # central-difference normals: azimuth wraps (roll), elevation clamps
    pa1, pa0 = torch.roll(P_img, -1, 1), torch.roll(P_img, 1, 1)
    va1, va0 = torch.roll(V_img, -1, 1), torch.roll(V_img, 1, 1)
    pe1 = torch.cat([P_img[1:], P_img[-1:]], 0)
    pe0 = torch.cat([P_img[:1], P_img[:-1]], 0)
    ve1 = torch.cat([V_img[1:], torch.zeros_like(V_img[-1:])], 0)
    ve0 = torch.cat([torch.zeros_like(V_img[:1]), V_img[:-1]], 0)
    n = _cross(pa1 - pa0, pe1 - pe0)
    nn = _norm3(n)
    n = n / torch.clamp(nn, min=1e-9)[..., None]
    # orient toward the sensor (sensor-frame origin): n . p <= 0
    n = torch.where((_dot3(n, P_img) > 0)[..., None], -n, n)
    n_ok = V_img & va1 & va0 & ve1 & ve0 & (nn > 1e-6)

    R, t = se3.pose_rotation(pose6), se3.pose_translation(pose6)
    return PrevScan(q_w=_rotate(R, P_img) + t, n_w=_rotate(R, n), pix_valid=n_ok,
                    depth=_norm3(pts3).reshape(B, A), pose6=pose6, elev_min=e_min, elev_max=e_max)


def build_prev_scan(sp: Scan2ScanParams, points: torch.Tensor, valid: torch.Tensor,
                    pose6: torch.Tensor) -> PrevScan:
    """K11a. Replaces the XLA fusion of nerfloam_tpu/core/scan2scan.py:
    98-155: rasterize the previous scan (points (P, 3) sensor frame, padded;
    valid (P,); pose6 (6,)) into a spherical range image of n_elev x n_az
    pixels. The per-pixel surface point is the mean of the pixel's points
    (it lies on the plane they sample, so planar residuals are unbiased);
    normals by central differences over the pixel grid, turned toward the
    sensor; both in the world frame. CPU tensors take
    ``build_prev_scan_plain``; CUDA tensors launch csrc/scan2scan.cu, whose
    per-pixel lists are walked in ascending point index, so the image is the
    same on every run."""
    dev = points.device
    if dev.type == "cpu":
        return build_prev_scan_plain(sp, points, valid, pose6)
    if dev.type != "cuda":
        raise ValueError(f"build_prev_scan: unsupported device {dev}")
    global build_prev_scan_launches
    B, A, P = sp.n_elev, sp.n_az, points.shape[0]
    total = B * A
    pts = points.float().contiguous()
    val = valid.to(torch.bool).contiguous()
    pose6 = pose6.float()
    if val.device != dev or pose6.device != dev:
        raise ValueError("build_prev_scan: all inputs must be on one device")
    R = se3.pose_rotation(pose6).contiguous()
    t = se3.pose_translation(pose6).contiguous()
    fbuf = torch.empty((2 * P + 3 * total,), dtype=torch.float32, device=dev)
    ibuf = torch.empty((P + total + 2,), dtype=torch.int32, device=dev)
    bbuf = torch.empty((P + total,), dtype=torch.uint8, device=dev)
    q_w = torch.empty((B, A, 3), dtype=torch.float32, device=dev)
    n_w = torch.empty((B, A, 3), dtype=torch.float32, device=dev)
    pix_valid = torch.empty((B, A), dtype=torch.bool, device=dev)
    depth = torch.empty((B, A), dtype=torch.float32, device=dev)
    span = torch.empty((2,), dtype=torch.float32, device=dev)
    f, i, b = fbuf.data_ptr(), ibuf.data_ptr(), bbuf.data_ptr()
    kernels.check(kernels.lib().nl_build_prev_scan(
        pts.data_ptr(), val.data_ptr(), P, R.data_ptr(), t.data_ptr(), B, A,
        sp.min_depth, sp.max_depth,
        f, f + 4 * P, b, i, i + 4 * P, i + 4 * (P + total), f + 8 * P, b + P,
        q_w.data_ptr(), n_w.data_ptr(), pix_valid.data_ptr(), depth.data_ptr(), span.data_ptr(),
        kernels.stream_ptr(dev)), "build_prev_scan")
    build_prev_scan_launches += 1
    return PrevScan(q_w=q_w, n_w=n_w, pix_valid=pix_valid, depth=depth, pose6=pose6,
                    elev_min=span[0], elev_max=span[1])


def _associate(sp: Scan2ScanParams, prev: PrevScan, pose6, pts, rvalid):
    """Per ray: world point, residual, weight and normal of its projective
    correspondence in the previous scan (scan2scan.py:170-201)."""
    B, A = sp.n_elev, sp.n_az
    Rc, tc = se3.pose_rotation(pose6), se3.pose_translation(pose6)
    Rp, tp = se3.pose_rotation(prev.pose6), se3.pose_translation(prev.pose6)
    p_w = _rotate(Rc, pts.float()) + tc                                 # (N, 3)
    # projective association: current points into the previous sensor frame
    p_prev = _rotate(Rp.transpose(0, 1), p_w - tp)
    az, elev, d = _angles(p_prev)
    bi_f = _elev_bin_f(elev, prev.elev_min, prev.elev_max, B)
    in_img = (bi_f >= -0.5) & (bi_f <= B - 0.5) & (d > sp.min_depth) & (d < sp.max_depth)
    pix = (_bin(bi_f, B) * A + _az_bin(az, A)).long()
    q = prev.q_w.reshape(-1, 3)[pix]
    n = prev.n_w.reshape(-1, 3)[pix]
    pv = prev.pix_valid.reshape(-1)[pix]
    pd = prev.depth.reshape(-1)[pix]
    r = _dot3(n, p_w - q)
    absr = r.abs()
    m = (rvalid & in_img & pv & (absr < sp.gate_dist) & ((d - pd).abs() < 2.0 * sp.gate_dist))
    # Huber IRLS weight
    w = torch.where(absr <= sp.huber, torch.ones_like(r),
                    torch.full_like(r, sp.huber) / torch.clamp(absr, min=1e-9))
    w = torch.where(m, w * sp.weight, torch.zeros_like(w))
    return p_w, tc, n, r, w


def s2s_system_plain(sp: Scan2ScanParams, prev: PrevScan, pose6, pts, rvalid):
    """Plain torch twin of K11b (scan2scan.py:170-211): point-to-plane
    normal-equation contributions at the current pose. Returns (H (6, 6),
    b (6,), loss ())."""
    p_w, t, n, r, w = _associate(sp, prev, pose6, pts, rvalid)
    J = torch.cat([n, _cross(p_w - t, n)], -1)                          # (N, 6)
    Jw = J * w[:, None]
    H = torch.einsum("ni,nj->ij", Jw, J)
    b = torch.einsum("ni,n->i", Jw, r)
    return H, b, torch.sum(w * r * r)


def s2s_system(sp: Scan2ScanParams, prev: PrevScan, pose6: torch.Tensor, pts: torch.Tensor,
               rvalid: torch.Tensor):
    """K11b. Replaces the XLA fusion of nerfloam_tpu/core/scan2scan.py:
    170-211: projective association of the current ray subset (pts (N, 3)
    sensor frame, rvalid (N,)) with the previous scan's range image, the
    gates, the Huber weight, J, and the sums H (6, 6), b (6,) and loss ()
    by a deterministic two-stage reduction. CPU tensors take
    ``s2s_system_plain``; CUDA tensors launch csrc/scan2scan.cu (one thread
    per ray)."""
    dev = pts.device
    if dev.type == "cpu":
        return s2s_system_plain(sp, prev, pose6, pts, rvalid)
    if dev.type != "cuda":
        raise ValueError(f"s2s_system: unsupported device {dev}")
    global s2s_system_launches
    lib = kernels.lib()
    B, A, N = sp.n_elev, sp.n_az, pts.shape[0]
    if prev.q_w.shape != (B, A, 3) or prev.depth.shape != (B, A):
        raise ValueError("s2s_system: the previous scan does not have the params' image shape")
    pose6, prev6 = pose6.float(), prev.pose6.float()
    ins = [t.contiguous() for t in (
        pts.float(), rvalid.to(torch.bool), se3.pose_rotation(pose6), se3.pose_translation(pose6),
        se3.pose_rotation(prev6), se3.pose_translation(prev6), prev.q_w.float(),
        prev.n_w.float(), prev.pix_valid.to(torch.bool), prev.depth.float(),
        prev.elev_min.float().reshape(1), prev.elev_max.float().reshape(1))]
    if any(t.device != dev for t in ins):
        raise ValueError("s2s_system: all inputs must be on one device")
    partial = torch.empty((lib.nl_s2s_blocks(N), lib.nl_s2s_partial_values()),
                          dtype=torch.float32, device=dev)
    H = torch.empty((6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((6,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    p = [t.data_ptr() for t in ins]
    kernels.check(lib.nl_s2s_system(
        p[0], p[1], N, *p[2:], B, A, sp.min_depth, sp.max_depth, sp.gate_dist,
        2.0 * sp.gate_dist, sp.huber, sp.weight, partial.data_ptr(), H.data_ptr(), b.data_ptr(),
        loss.data_ptr(), kernels.stream_ptr(dev)), "s2s_system")
    s2s_system_launches += 1
    return H, b, loss
