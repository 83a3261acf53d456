"""Differentiable SE(3) pose parameterization (port of nerfloam_tpu/ops/se3.py).

pose6 = [t (3), w (3)]: raw translation plus axis-angle rotation,
R = exp([w]x) in closed form with a grad-safe small-angle branch. All
matmuls run in true float32 (TF32 is off, see the package __init__).

exp_so3 of a CUDA tensor is one launch of csrc/exp_so3.cu forward and one
backward (``exp_so3_launches`` counts both); its plain twin,
``exp_so3_plain``, is the chain of ops that a CPU tensor takes.
"""

from __future__ import annotations

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.ops import trig
from nerfloam_tpu_torch.ops.ieee import const, div, fma_f32, norm3, sqrt_rn

_SMALL = 1e-8  # theta^2 switch point for the series branches

exp_so3_launches = 0


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
    """a @ b of (..., 3, 3) CPU matrices, each entry rounded as XLA's CPU
    dot forms it, fma(a2, b2, fma(a1, b1, a0 * b0)); the backward is the
    product's, dA = dC b^T and dB = a^T dC."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        rows = [fma_f32(a[..., i, 2:3], b[..., 2, :],
                         fma_f32(a[..., i, 1:2], b[..., 1, :], a[..., i, 0:1] * b[..., 0, :]))
                for i in range(3)]
        return torch.stack(rows, -2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return torch.matmul(g, b.transpose(-1, -2)), torch.matmul(a.transpose(-1, -2), g)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of (..., 3, 3) matrices rounded as XLA's CPU dot forms each
    entry, fma(a2, b2, fma(a1, b1, a0 * b0)). torch's CPU product does so
    for one matrix but adds a batch's without fused multiply-adds, so a CPU
    batch takes ``_Matmul3``; on the card the chain is three elementwise
    launches, ``addcmul`` being one fused multiply-add there (cuBLAS's
    product rounds otherwise; chip_smoke's [ieee] holds the chain to the
    CPU's)."""
    if a.is_cuda:
        out = a[..., :, 0:1] * b[..., 0:1, :]
        out = torch.addcmul(out, a[..., :, 1:2], b[..., 1:2, :])
        return torch.addcmul(out, a[..., :, 2:3], b[..., 2:3, :])
    if a.dim() == 2:
        return torch.matmul(a, b)
    return _Matmul3.apply(a, b)


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
