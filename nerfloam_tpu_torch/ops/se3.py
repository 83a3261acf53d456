"""Differentiable SE(3) pose parameterization (port of nerfloam_tpu/ops/se3.py).

pose6 = [t (3), w (3)]: raw translation plus axis-angle rotation,
R = exp([w]x) in closed form with a grad-safe small-angle branch. All
matmuls run in true float32 (TF32 is off, see the package __init__).

A pose's rays, origins and directions in the world (BA's iterations and
superset, the Adam tracker, the tp BA iteration, the GN tracker's first
rotation), are ``pose_rays``: on CUDA tensors one launch of
csrc/pose_rays.cu forward and one backward (``pose_rays_launches`` counts
both), exp_so3 folded in; its plain twin ``pose_rays_plain`` is the chain
of ops (``exp_so3_plain``, ``rotate_rows``) with autograd. The other
rotations (the map's insert, the scan-to-scan term, the bias probe, the
warm start's pose matrices) take exp_so3, one launch of csrc/exp_so3.cu
forward and one backward on the card (``exp_so3_launches`` counts both);
its plain twin, ``exp_so3_plain``, is the chain of ops that a CPU tensor
takes. The deferred warm start, ``const_vel`` (two pose matrices, their
products, the log), is one launch of csrc/const_vel.cu on the card
(``const_vel_launches``), bit for bit its plain twin ``const_vel_plain``.
"""

from __future__ import annotations

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.ops import trig
from nerfloam_tpu_torch.ops.ieee import const, div, fma_f32, norm3, sqrt_rn

_SMALL = 1e-8  # theta^2 switch point for the series branches

exp_so3_launches = 0
pose_rays_launches = 0
const_vel_launches = 0
_F32 = torch.float32


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
    divide as JAX does (one IEEE division each, ``ieee.div``), the root is
    rounded once (``ieee.sqrt_rn``) and the sine and cosine are
    ``ops/trig``'s, rounded as XLA's CPU backend (the host's
    glibc) rounds them, where torch's differ on up to ~5% of angles."""
    small = theta2 < _SMALL
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = sqrt_rn(safe_t2)
    a_exact = trig.sin(theta) / theta
    b_exact = (1.0 - trig.cos(theta)) / safe_t2
    t4 = theta2 * theta2
    a_series = 1.0 - div(theta2, 6.0) + div(t4, 120.0)
    b_series = 0.5 - div(theta2, 24.0) + div(t4, 720.0)
    return torch.where(small, a_series, a_exact), torch.where(small, b_series, b_exact)


class _Matmul3(torch.autograd.Function):
    """a @ b of (..., m, 3) and (..., 3, k) CPU matrices, each entry rounded
    as XLA's CPU dot forms it, fma(a2, b2, fma(a1, b1, a0 * b0)); the
    backward is the product's, dA = dC b^T and dB = a^T dC."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fma_f32(a[..., 2:3], b[..., 2:3, :],
                       fma_f32(a[..., 1:2], b[..., 1:2, :], a[..., 0:1] * b[..., 0:1, :]))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return torch.matmul(g, b.transpose(-1, -2)), torch.matmul(a.transpose(-1, -2), g)


def _chain3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of (..., m, 3) and (..., 3, k) matrices, each entry
    fma(a2, b2, fma(a1, b1, a0 * b0)): on the card three elementwise
    launches, ``addcmul`` being one fused multiply-add there; on the CPU
    ``_Matmul3``."""
    if a.is_cuda:
        out = a[..., :, 0:1] * b[..., 0:1, :]
        out = torch.addcmul(out, a[..., :, 1:2], b[..., 1:2, :])
        return torch.addcmul(out, a[..., :, 2:3], b[..., 2:3, :])
    return _Matmul3.apply(a, b)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of (..., 3, 3) matrices rounded as XLA's CPU dot forms each
    entry, fma(a2, b2, fma(a1, b1, a0 * b0)). torch's CPU product does so
    for one matrix but adds a batch's without fused multiply-adds, so a CPU
    batch takes ``_Matmul3``; on the card the chain is three elementwise
    launches (cuBLAS's product rounds otherwise; chip_smoke's [ieee] holds
    the chain to the CPU's)."""
    if not a.is_cuda and a.dim() == 2:
        return torch.matmul(a, b)
    return _chain3(a, b)


def rotate_rows(dirs: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """dirs (..., N, 3) rotated by R (..., 3, 3), d R^T, each entry
    fma(d2, R_i2, fma(d1, R_i1, d0 * R_i0)), the order XLA's CPU dot
    forms (N, 3) x (3, 3) in (torch's CPU product forms it so too); the
    rotation of csrc/lm_step.cu's tail and csrc/pose_rays.cu, bit for bit.
    Differentiable."""
    return _chain3(dirs, R.transpose(-1, -2))


def exp_so3_plain(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp([w]x) for w (..., 3) -> rotation matrices (..., 3, 3)
    by the chain of ops (the plain twin of csrc/exp_so3.cu). theta^2 is
    summed left to right, as JAX's op-by-op sum and the kernels add it;
    torch.sum on the card adds in another order."""
    w0, w1, w2 = w.unbind(-1)
    theta2 = (w0 * w0 + w1 * w1) + w2 * w2
    a, b = _sinc_coeffs(theta2)
    wx = skew(w)
    wx2 = _matmul3(wx, wx)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * wx + b[..., None, None] * wx2


def exp_so3_fwd(rows: torch.Tensor, lead: tuple) -> torch.Tensor:
    """One launch of csrc/exp_so3.cu's forward: rows (n, 3) f32 on the card
    with a last stride of 1 -> ``lead + (3, 3)`` (n = prod(lead))."""
    global exp_so3_launches
    n = rows.shape[0]
    R = torch.empty(tuple(lead) + (3, 3), dtype=torch.float32, device=rows.device)
    if n:
        err = kernels.lib().nl_exp_so3_fwd(rows.data_ptr(), rows.stride(0), n, R.data_ptr(),
                                           kernels.stream_ptr(rows.device))
        kernels.check(err, "exp_so3")
        exp_so3_launches += 1
    return R


def exp_so3_bwd(rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/exp_so3.cu's backward: the rows' cotangent (n, 3)
    from R's, ``g`` (n, 3, 3)."""
    global exp_so3_launches
    n = rows.shape[0]
    G = g.reshape(n, 9).contiguous()
    gw = torch.empty((n, 3), dtype=torch.float32, device=rows.device)
    if n:
        err = kernels.lib().nl_exp_so3_bwd(rows.data_ptr(), rows.stride(0), G.data_ptr(), n,
                                           gw.data_ptr(), kernels.stream_ptr(rows.device))
        kernels.check(err, "exp_so3 backward")
        exp_so3_launches += 1
    return gw


def _rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., 3) as (n, 3) rows at one row stride: a pose's [3:6] is
    read in place."""
    rows = w.reshape(-1, 3)
    return rows if rows.stride(-1) == 1 else rows.contiguous()


class _ExpSO3(torch.autograd.Function):
    """exp_so3 of an f32 CUDA tensor: csrc/exp_so3.cu, one launch each way."""

    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        return exp_so3_fwd(_rows(w), w.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return exp_so3_bwd(_rows(w), g).view(w.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp([w]x) for w (..., 3) -> rotation matrices (..., 3, 3),
    rounded as JAX's on the CPU. A CPU tensor takes ``exp_so3_plain``; a
    CUDA tensor must be f32 (else ValueError) and takes csrc/exp_so3.cu,
    whose forward is the chain's bit for bit and whose backward agrees with
    the chain's autograd to rounding."""
    if not w.is_cuda:
        return exp_so3_plain(w)
    if w.dtype != torch.float32 or w.shape[-1] != 3:
        raise ValueError(f"exp_so3: w must be (..., 3) f32 on the card; got {w.dtype} of shape "
                         f"{tuple(w.shape)}")
    return _ExpSO3.apply(w)


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
    sw = 2.0 * sqrt_rn(torch.clamp(tw, min=eps))
    sx = 2.0 * sqrt_rn(torch.clamp(tx, min=eps))
    sy = 2.0 * sqrt_rn(torch.clamp(ty, min=eps))
    sz = 2.0 * sqrt_rn(torch.clamp(tz, min=eps))
    qw = torch.stack([sw * 0.25, r21 / sw, r02 / sw, r10 / sw], dim=-1)
    qx = torch.stack([r21 / sx, sx * 0.25, s01 / sx, s02 / sx], dim=-1)
    qy = torch.stack([r02 / sy, s01 / sy, sy * 0.25, s12 / sy], dim=-1)
    qz = torch.stack([r10 / sz, s02 / sz, s12 / sz, sz * 0.25], dim=-1)
    idx = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)[..., None]
    q = torch.where(idx == 0, qw, torch.where(idx == 1, qx, torch.where(idx == 2, qy, qz)))
    q = q * torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    vec = q[..., 1:4]
    n = norm3(vec.contiguous())
    theta = 2.0 * trig.atan2(n, q[..., 0])
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


def _pose_rays_check(poses, dirs):
    """Raise ValueError unless poses (6,) and dirs (N, 3), or poses (W, 6)
    and dirs (W, N, 3), are contiguous f32 on one device, dirs needing no
    gradient."""
    name = "pose_rays"
    kernels.expect(name, poses.device, _F32, poses=poses, dirs=dirs)
    one = poses.dim() == 1
    W = 1 if one else poses.shape[0]
    ok = poses.shape[-1] == 6 and poses.dim() in (1, 2) and dirs.dim() == poses.dim() + 1
    N = dirs.shape[-2] if ok else -1
    if not ok or tuple(dirs.shape) != ((N, 3) if one else (W, N, 3)):
        raise ValueError(f"{name}: poses (6,) with dirs (N, 3), or (W, 6) with (W, N, 3); got "
                         f"{tuple(poses.shape)} and {tuple(dirs.shape)}")
    if dirs.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: no gradient for dirs; pass directions that need none")


def pose_rays_plain(poses: torch.Tensor, dirs: torch.Tensor, with_R: bool = False):
    """Plain twin of ``pose_rays``, the chain of ops with autograd:
    ``exp_so3_plain`` of the poses' rotations, ``rotate_rows`` of the
    directions, and the translations broadcast (one frame: expanded, row
    stride 0; a window: reshaped into rows, a copy). Returns (origins,
    wdirs) as rows, and R where ``with_R``."""
    R = exp_so3_plain(poses[..., 3:6])
    wdirs = rotate_rows(dirs, R)
    t = poses[..., :3]
    if poses.dim() == 1:
        origins = t.expand_as(wdirs)
    else:
        n = wdirs.shape[0] * wdirs.shape[1]
        origins, wdirs = t[:, None, :].expand_as(wdirs).reshape(n, 3), wdirs.reshape(n, 3)
    return (origins, wdirs, R) if with_R else (origins, wdirs)


def pose_rays_fwd(poses: torch.Tensor, dirs: torch.Tensor):
    """One launch of csrc/pose_rays.cu's forward on checked CUDA tensors:
    (origins, wdirs, R) as ``pose_rays_plain`` shapes them, views of one
    new buffer; one frame's origins its t expanded (row stride 0), a
    window's written as rows."""
    global pose_rays_launches
    one = poses.dim() == 1
    W = 1 if one else poses.shape[0]
    N = dirs.shape[-2]
    n = 3 * W * N
    rows = W > 1
    m = 2 * n if rows else n  # wdirs, then a window's origin rows; R (W, 9), t (W, 3)
    buf = torch.empty((m + 12 * W,), dtype=_F32, device=poses.device)
    o = buf.data_ptr()
    err = kernels.lib().nl_pose_rays_fwd(poses.data_ptr(), dirs.data_ptr(), W, N, o,
                                         o + 4 * n if rows else None, o + 4 * m,
                                         o + 4 * (m + 9 * W), kernels.stream_ptr(poses.device))
    kernels.check(err, "pose_rays")
    pose_rays_launches += 1
    wdirs = buf[:n].view(dirs.shape if one else (W * N, 3))
    R = buf[m:m + 9 * W].view((3, 3) if one else (W, 3, 3))
    origins = buf[n:m].view(W * N, 3) if rows else buf[m + 9 * W:].view(1, 3).expand(N, 3)
    return origins, wdirs, R


def pose_rays_bwd(poses: torch.Tensor, dirs: torch.Tensor, g_orig, g_wdirs) -> torch.Tensor:
    """One launch of csrc/pose_rays.cu's backward: the poses' gradient
    (poses' shape) from the cotangents of the origins and the directions
    (rows, or None for zero)."""
    global pose_rays_launches
    W = 1 if poses.dim() == 1 else poses.shape[0]
    N = dirs.shape[-2]
    g = torch.empty_like(poses)
    g_orig = None if g_orig is None else g_orig.contiguous()
    g_wdirs = None if g_wdirs is None else g_wdirs.contiguous()
    err = kernels.lib().nl_pose_rays_bwd(
        poses.data_ptr(), dirs.data_ptr(), None if g_orig is None else g_orig.data_ptr(),
        None if g_wdirs is None else g_wdirs.data_ptr(), W, N, g.data_ptr(),
        kernels.stream_ptr(poses.device))
    kernels.check(err, "pose_rays backward")
    pose_rays_launches += 1
    return g


class _PoseRays(torch.autograd.Function):
    """pose_rays of CUDA tensors: csrc/pose_rays.cu, one launch each way."""

    @staticmethod
    def forward(ctx, poses, dirs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(poses, dirs)
        origins, wdirs, R = pose_rays_fwd(poses, dirs)
        ctx.mark_non_differentiable(R)
        return origins, wdirs, R

    @staticmethod
    def backward(ctx, g_orig, g_wdirs, _):
        if g_orig is None and g_wdirs is None:
            return None, None
        poses, dirs = ctx.saved_tensors
        return pose_rays_bwd(poses, dirs, g_orig, g_wdirs), None


def pose_rays(poses: torch.Tensor, dirs: torch.Tensor, with_R: bool = False):
    """A pose's rays in the world: origins t and directions d R^T, R =
    exp_so3(w), for poses (6,) with dirs (N, 3) (a tracker's frame) or
    poses (W, 6) with dirs (W, N, 3) (BA's window), contiguous f32 on one
    device (else ValueError, on the CPU too; dirs need no gradient).
    Returns (origins, wdirs) as (N, 3) or (W * N, 3) rows, and R ((3, 3)
    or (W, 3, 3), no gradient) where ``with_R``; one frame's origins are
    its t expanded, row stride 0. Differentiable in the poses. The XLA
    fusion of nerfloam_tpu/core/ba.py:253-256 (and of se3.rotate_dirs in
    the trackers). CPU tensors take ``pose_rays_plain``; CUDA tensors one
    launch of csrc/pose_rays.cu forward, its origins and directions
    torch.equal to the twin's, and one backward, within rounding of the
    twin's autograd (the sums' order)."""
    _pose_rays_check(poses, dirs)
    if poses.device.type == "cpu":
        return pose_rays_plain(poses, dirs, with_R)
    if poses.device.type != "cuda":
        raise ValueError(f"pose_rays: unsupported device {poses.device}")
    if torch.is_grad_enabled() and poses.requires_grad:
        out = _PoseRays.apply(poses, dirs)
    else:
        out = pose_rays_fwd(poses, dirs)
    return out if with_R else out[:2]


def rotate_dirs(p6: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors by the pose rotation (no translation)."""
    return torch.matmul(dirs, pose_rotation(p6).transpose(-1, -2))


def inv_transform_points(p6: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R^T @ (p - t)."""
    return torch.matmul(pts - pose_translation(p6)[..., None, :], pose_rotation(p6))


def compose_matrices(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B; 3x3 rotations rounded as XLA's CPU dot (``_matmul3``)."""
    return _matmul3(A, B) if A.shape[-1] == 3 else torch.matmul(A, B)


def invert_matrix(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -torch.matmul(Rt, T[..., :3, 3:4])
    top = torch.cat([Rt, t], dim=-1)
    return torch.cat([top, T[..., 3:4, :]], dim=-2)


def _dot4(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B of (..., 4, 4) f32 matrices, each entry fma(a3, b3, fma(a2, b2,
    fma(a1, b1, a0 * b0))): XLA's CPU dot, and torch's CPU product of one
    matrix."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in (1, 2, 3):
        acc = fma_f32(A[..., :, k:k + 1], B[..., k:k + 1, :], acc)
    return acc


def const_vel_plain(last6: torch.Tensor, prev6: torch.Tensor, full: bool) -> torch.Tensor:
    """Plain twin of ``const_vel`` over (..., 6) poses, op by op: the pose
    matrices (exp_so3), inv(T_prev)'s translation -(R^T t) and the 4 x 4
    products in the dot's fma order, and ``log_so3``; one pair of
    (6,) poses gives what the chain of se3's matrix ops gives on the CPU
    (JAX ``_const_vel_jit``'s ops, op by op)."""
    t_last, t_prev = pose_matrix(last6), pose_matrix(prev6)
    Rt = t_prev[..., :3, :3].transpose(-1, -2)
    tp = t_prev[..., :3, 3]
    t_inv = -fma_f32(Rt[..., 2], tp[..., 2:3], fma_f32(Rt[..., 1], tp[..., 1:2],
                                                        Rt[..., 0] * tp[..., 0:1]))
    inv = torch.cat([torch.cat([Rt, t_inv[..., None]], -1), t_prev[..., 3:, :]], -2)
    t_const = _dot4(t_last, _dot4(inv, t_last))
    R = t_const[..., :3, :3] if full else t_last[..., :3, :3]
    return torch.cat([t_const[..., :3, 3], log_so3(R)], -1)


def const_vel(last6: torch.Tensor, prev6: torch.Tensor, full: bool) -> torch.Tensor:
    """The constant-velocity warm start from the raw tracked poses of the
    two frames before (JAX ``_const_vel_jit``, nerfloam_tpu/core/pipeline.py:
    60-72): rel = inv(T_prev) T_last, init = T_last rel, as pose6;
    ``full=False`` moves the translation alone. ``last6`` and ``prev6``
    (..., 6) f32. CPU tensors take ``const_vel_plain``; CUDA tensors (f32,
    contiguous, else ValueError) one launch of csrc/const_vel.cu, equal to
    it bit for bit."""
    name, dev = "const_vel", last6.device
    if dev.type == "cpu":
        return const_vel_plain(last6, prev6, full)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    global const_vel_launches
    kernels.expect(name, dev, _F32, last6=last6, prev6=prev6)
    if last6.shape[-1:] != (6,) or prev6.shape != last6.shape:
        raise ValueError(f"{name}: last6 and prev6 must be (..., 6) of one shape; got "
                         f"{tuple(last6.shape)} and {tuple(prev6.shape)}")
    out = torch.empty_like(last6)
    n = last6.numel() // 6
    if n:
        kernels.check(kernels.lib().nl_const_vel(last6.data_ptr(), prev6.data_ptr(), n, int(full),
                                                 out.data_ptr(), kernels.stream_ptr(dev)), name)
        const_vel_launches += 1
    return out
