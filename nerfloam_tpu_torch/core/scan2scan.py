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
left-perturbation Jacobian J = [n_w, (p_w - t) x n_w]: K11b ``s2s_system``,
which adds its sums in place to the SDF term's system (K3's outputs)
before the LM solve. Both rotations are built once where they are known:
the previous pose's with the range image (``PrevScan.R`` / ``.t``), the
current one by the tracker, which rotates its ray directions with it.

Both kernels live in csrc/scan2scan.cu; the plain twins beside the wrappers
run on CPU tensors and repeat the kernels' arithmetic one rounded operation
at a time (no matrix products, whose summation order the library picks),
so bins, pixels and validity agree exactly on the card. The lengths (the
range, the horizontal range, a pixel's depth and its normal's length) are
``jnp.linalg.norm``'s, bit for bit: XLA's CPU chain of fused multiply-adds
(``ieee.norm3_plain`` / ``norm2_plain``; csrc/ieee.cuh in the kernels).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.map.voxel_map import _add_in_order, div
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.ieee import norm2_plain, norm3_plain

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
    R: torch.Tensor          # (3, 3) se3.pose_rotation(pose6), built once per frame
    t: torch.Tensor          # (3,) se3.pose_translation(pose6)


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
    d = norm3_plain(pts)
    az = torch.atan2(pts[..., 1], pts[..., 0])              # [-pi, pi]
    horiz = norm2_plain(pts)
    return az, torch.atan2(pts[..., 2], horiz + 1e-12), d


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
    nn = norm3_plain(n)
    n = n / torch.clamp(nn, min=1e-9)[..., None]
    # orient toward the sensor (sensor-frame origin): n . p <= 0
    n = torch.where((_dot3(n, P_img) > 0)[..., None], -n, n)
    n_ok = V_img & va1 & va0 & ve1 & ve0 & (nn > 1e-6)

    R, t = se3.pose_rotation(pose6), se3.pose_translation(pose6)
    return PrevScan(q_w=_rotate(R, P_img) + t, n_w=_rotate(R, n), pix_valid=n_ok,
                    depth=norm3_plain(pts3).reshape(B, A), pose6=pose6, elev_min=e_min,
                    elev_max=e_max, R=R, t=t)


def build_prev_scan(sp: Scan2ScanParams, points: torch.Tensor, valid: torch.Tensor,
                    pose6: torch.Tensor) -> PrevScan:
    """K11a. Replaces the XLA fusion of nerfloam_tpu/core/scan2scan.py:
    98-155: rasterize the previous scan (points (P, 3) sensor frame, padded;
    valid (P,); pose6 (6,)) into a spherical range image of n_elev x n_az
    pixels. The per-pixel surface point is the mean of the pixel's points
    (it lies on the plane they sample, so planar residuals are unbiased);
    normals by central differences over the pixel grid, turned toward the
    sensor; both in the world frame, by the rotation built here once
    (``se3.pose_rotation``, kept as ``PrevScan.R`` for K11b).

    CPU tensors take ``build_prev_scan_plain``; CUDA tensors launch
    csrc/scan2scan.cu once (a cooperative launch whose pixels add their
    points in ascending index, so the image is the same on every run), on
    inputs as the kernel reads them (contiguous f32 points and pose6, bool
    valid, on one device): nothing is converted, anything else raises
    ValueError."""
    dev = points.device
    if dev.type == "cpu":
        return build_prev_scan_plain(sp, points, valid, pose6)
    if dev.type != "cuda":
        raise ValueError(f"build_prev_scan: unsupported device {dev}")
    global build_prev_scan_launches
    name, B, A, P = "build_prev_scan", sp.n_elev, sp.n_az, points.shape[0]
    kernels.expect(name, dev, torch.float32, points=points, pose6=pose6)
    kernels.expect(name, dev, torch.bool, valid=valid)
    kernels.expect_shape(name, points=(points, (P, 3)), valid=(valid, (P,)), pose6=(pose6, (6,)))
    lib = kernels.lib()
    total = B * A
    R = se3.pose_rotation(pose6)
    t = se3.pose_translation(pose6)
    out = torch.empty((7 * total + 2,), dtype=torch.float32, device=dev)
    pix_valid = torch.empty((B, A), dtype=torch.bool, device=dev)
    # scratch: elev (P f32), abin, next (P i32 each), head (total i32), the
    # blocks' spans, p_img (3 total f32), has_pt (total bytes)
    n_part = lib.nl_range_image_part_ints()
    scratch = torch.empty((4 * (3 * P + 4 * total + n_part) + total,), dtype=torch.uint8,
                          device=dev)
    s = scratch.data_ptr()
    elev, abin, nxt, head = s, s + 4 * P, s + 8 * P, s + 12 * P
    part = head + 4 * total
    p_img = part + 4 * n_part
    has_pt = p_img + 12 * total
    o = out.data_ptr()
    kernels.check(lib.nl_build_prev_scan(
        points.data_ptr(), valid.data_ptr(), P, R.data_ptr(), t.data_ptr(), B, A, sp.min_depth,
        sp.max_depth, elev, abin, nxt, head, part, p_img, has_pt, o, o + 12 * total,
        pix_valid.data_ptr(), o + 24 * total, o + 28 * total, kernels.stream_ptr(dev)), name)
    build_prev_scan_launches += 1
    return PrevScan(q_w=out[:3 * total].view(B, A, 3), n_w=out[3 * total:6 * total].view(B, A, 3),
                    pix_valid=pix_valid, depth=out[6 * total:7 * total].view(B, A), pose6=pose6,
                    elev_min=out[7 * total], elev_max=out[7 * total + 1], R=R, t=t)


def _associate(sp: Scan2ScanParams, prev: PrevScan, pose6, pts, rvalid, R=None):
    """Per ray: world point, residual, weight and normal of its projective
    correspondence in the previous scan (scan2scan.py:170-201). ``R`` is
    se3.pose_rotation(pose6), built here when not given."""
    B, A = sp.n_elev, sp.n_az
    Rc = se3.pose_rotation(pose6) if R is None else R
    tc = se3.pose_translation(pose6)
    p_w = _rotate(Rc, pts) + tc                                         # (N, 3)
    # projective association: current points into the previous sensor frame
    p_prev = _rotate(prev.R.transpose(0, 1), p_w - prev.t)
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


def s2s_system_plain(sp: Scan2ScanParams, prev: PrevScan, pose6, pts, rvalid, R=None, acc=None):
    """Plain torch twin of K11b (scan2scan.py:170-211): point-to-plane
    normal-equation contributions at the current pose, (H (6, 6), b (6,),
    loss ()). With ``acc = (H0, b0, loss0)`` they are added to those in
    place and the three are returned, as the kernel does."""
    p_w, t, n, r, w = _associate(sp, prev, pose6, pts, rvalid, R)
    J = torch.cat([n, _cross(p_w - t, n)], -1)                          # (N, 6)
    Jw = J * w[:, None]
    H = torch.einsum("ni,nj->ij", Jw, J)
    b = torch.einsum("ni,n->i", Jw, r)
    loss = torch.sum(w * r * r)
    if acc is None:
        return H, b, loss
    return acc[0].add_(H), acc[1].add_(b), acc[2].add_(loss)


def _check_s2s_args(sp: Scan2ScanParams, prev: PrevScan, pose6, pts, rvalid, R, acc):
    name, dev, f32 = "s2s_system", pts.device, torch.float32
    N, B, A = pts.shape[0], sp.n_elev, sp.n_az
    kernels.expect(name, dev, f32, pts=pts, pose6=pose6, R=R, prev_R=prev.R, prev_t=prev.t,
                   q_w=prev.q_w, n_w=prev.n_w, depth=prev.depth, elev_min=prev.elev_min,
                   elev_max=prev.elev_max)
    kernels.expect(name, dev, torch.bool, rvalid=rvalid, pix_valid=prev.pix_valid)
    kernels.expect_shape(name, pts=(pts, (N, 3)), rvalid=(rvalid, (N,)), pose6=(pose6, (6,)),
                         R=(R, (3, 3)), prev_R=(prev.R, (3, 3)), prev_t=(prev.t, (3,)),
                         q_w=(prev.q_w, (B, A, 3)), n_w=(prev.n_w, (B, A, 3)),
                         pix_valid=(prev.pix_valid, (B, A)), depth=(prev.depth, (B, A)),
                         elev_min=(prev.elev_min, ()), elev_max=(prev.elev_max, ()))
    if acc is not None:
        kernels.expect(name, dev, f32, H=acc[0], b=acc[1], loss=acc[2])
        kernels.expect_shape(name, H=(acc[0], (6, 6)), b=(acc[1], (6,)), loss=(acc[2], ()))


def s2s_system(sp: Scan2ScanParams, prev: PrevScan, pose6: torch.Tensor, pts: torch.Tensor,
               rvalid: torch.Tensor, R: torch.Tensor | None = None, acc=None):
    """K11b. Replaces the XLA fusion of nerfloam_tpu/core/scan2scan.py:
    170-211: projective association of the current ray subset (pts (N, 3)
    sensor frame, rvalid (N,)) with the previous scan's range image, the
    gates, the Huber weight, J, and the sums H (6, 6), b (6,) and loss ().
    ``R`` is se3.pose_rotation(pose6) when the caller has it (the tracker
    does), else it is built here; the previous pose's comes from ``prev``.
    ``acc = (H0, b0, loss0)``, f32 tensors of those shapes, takes the sums
    in place (the tracker passes K3's outputs) and is returned.

    Every input must already be what the kernel reads (f32 or bool,
    contiguous, on one device): nothing is converted. CPU tensors take
    ``s2s_system_plain``; CUDA tensors launch csrc/scan2scan.cu once: one
    cluster of 8 blocks whose sums are the same on every run."""
    dev = pts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"s2s_system: unsupported device {dev}")
    if R is None:
        R = se3.pose_rotation(pose6)
    _check_s2s_args(sp, prev, pose6, pts, rvalid, R, acc)
    if dev.type == "cpu":
        return s2s_system_plain(sp, prev, pose6, pts, rvalid, R, acc)
    global s2s_system_launches
    if acc is None:
        out = torch.empty((43,), dtype=torch.float32, device=dev)
        H, b, loss = out[:36].view(6, 6), out[36:42], out[42]
    else:
        H, b, loss = acc
    kernels.check(kernels.lib().nl_s2s_system(
        pts.data_ptr(), rvalid.data_ptr(), pts.shape[0], R.data_ptr(), pose6.data_ptr(),
        prev.R.data_ptr(), prev.t.data_ptr(), prev.q_w.data_ptr(), prev.n_w.data_ptr(),
        prev.pix_valid.data_ptr(), prev.depth.data_ptr(), prev.elev_min.data_ptr(),
        prev.elev_max.data_ptr(), sp.n_elev, sp.n_az, sp.min_depth, sp.max_depth, sp.gate_dist,
        2.0 * sp.gate_dist, sp.huber, sp.weight, acc is not None, H.data_ptr(), b.data_ptr(),
        loss.data_ptr(), kernels.stream_ptr(dev)), "s2s_system")
    s2s_system_launches += 1
    return H, b, loss
