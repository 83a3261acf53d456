"""Hits-sampler field evaluation (port of nerfloam_tpu/core/render.py:72-150).

``hits_field_fwd`` is kernel K1 and ``hits_field_bwd`` kernel K2
(csrc/hits_field.cu) on CUDA tensors; on CPU tensors each takes its plain
torch twin. ``render_rays_hits`` wraps both in one autograd Function over
(packed, rays_o, rays_d): K1 returns the features and the sample
positions, and the backward maps K2's d xyz onto the rays
(d o = sum_m d xyz, d d = sum_m z d xyz, since xyz = o + d z with z fixed
by the hit table and the jitter). The cell that re-resolves a sample and
the cell that interpolates it come from the same xyz, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core.losses import MAX_DEPTH
from nerfloam_tpu_torch.models.decoder import decoder_apply
from nerfloam_tpu_torch.ops.interp import interp_corner_features
from nerfloam_tpu_torch.ops.raycast import (
    HitTable,
    cells_of,
    div,
    resolve_cells_in_hits,
    sample_from_hits,
)

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
hits_field_fwd_launches = 0
hits_field_bwd_launches = 0

_JITTER_LO, _JITTER_HI = 1e-4, 1.0 - 1e-4  # frac clip of sample_from_hits


class RenderOutput(NamedTuple):
    z_vals: torch.Tensor      # (R, M), MAX_DEPTH where invalid
    sdf: torch.Tensor         # (R, M), 1.0 where invalid
    ray_mask: torch.Tensor    # (R,)
    valid_mask: torch.Tensor  # (R, M)
    sampled_xyz: torch.Tensor  # (R, M, 3)


def interp_packed(xyz: torch.Tensor, rows: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Trilinear features of packed corner rows (..., 8F) at xyz (..., 3);
    the interpolation cell is the sample's own cell floor(xyz / vs)."""
    F = rows.shape[-1] // 8
    center = (torch.floor(div(xyz, voxel_size)) + 0.5) * voxel_size
    return interp_corner_features(xyz, center, rows.reshape(rows.shape[:-1] + (8, F)), voxel_size)


# ---------------------------------------------------------------- K1 / K2


def hits_field_fwd_plain(ht: HitTable, u, rays_o, rays_d, packed, voxel_size):
    """Plain torch twin of K1: (z, valid, aid, xyz, feats) per sample."""
    M = u.shape[1]
    z, _, _, pvalid, _ = sample_from_hits(ht, M, u)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    _, aid, found = resolve_cells_in_hits(ht, cells_of(xyz, voxel_size))
    valid = pvalid & found
    rows = packed[torch.clamp(aid, min=0).long()]
    feats = torch.where(valid[..., None], interp_packed(xyz, rows, voxel_size), 0.0)
    return z, valid, torch.where(valid, aid, -1), xyz, feats


def hits_field_fwd(ht: HitTable, u, rays_o, rays_d, packed, voxel_size):
    """K1: stratified placement over the hit table, in-register voxel
    re-resolution, one packed row and trilinear features per sample.
    Replaces the XLA fusion of nerfloam_tpu/core/render.py:132-147 over
    ops/raycast.py:248-324, render.py:91-105 and interp.py:22-47 (up to the
    decoder). Bound: one 512 B packed row read per valid sample (see
    csrc/hits_field.cu). Returns (z, valid, aid, xyz, feats)."""
    if packed.device.type == "cpu":
        return hits_field_fwd_plain(ht, u, rays_o, rays_d, packed, voxel_size)
    if packed.device.type != "cuda":
        raise ValueError(f"hits_field_fwd: unsupported device {packed.device}")
    global hits_field_fwd_launches
    dev = packed.device
    R, H = ht.aid.shape
    M = u.shape[1]
    if packed.shape[1] != 128:
        raise ValueError("hits_field_fwd: packed rows must be 8 x 16 floats")
    ins = [t.contiguous() for t in (ht.aid.to(torch.int32), ht.t_near.float(), ht.seg.float(),
                                     ht.cdf.float(), ht.cell.to(torch.int32), u.float(),
                                     rays_o.float(), rays_d.float(), packed.float())]
    if any(t.device != dev for t in ins):
        raise ValueError("hits_field_fwd: all inputs must be on one device")
    z = torch.empty((R, M), dtype=torch.float32, device=dev)
    valid = torch.empty((R, M), dtype=torch.bool, device=dev)
    aid = torch.empty((R, M), dtype=torch.int32, device=dev)
    xyz = torch.empty((R, M, 3), dtype=torch.float32, device=dev)
    feats = torch.empty((R, M, 16), dtype=torch.float32, device=dev)
    err = kernels.lib().nl_hits_field_fwd(
        *[t.data_ptr() for t in ins], R, M, H, voxel_size, _JITTER_LO, _JITTER_HI,
        z.data_ptr(), valid.data_ptr(), aid.data_ptr(), xyz.data_ptr(), feats.data_ptr(),
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "hits_field_fwd")
    hits_field_fwd_launches += 1
    return z, valid, aid, xyz, feats


def hits_field_bwd_plain(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked):
    """Plain torch twin of K2, by autograd through the plain interpolation
    (center fixed): returns (d xyz, d packed or None)."""
    with torch.enable_grad():
        x = xyz.detach().requires_grad_(True)
        safe = torch.clamp(aid, min=0).long()
        rows = packed.detach()[safe].requires_grad_(want_dpacked)
        center = (torch.floor(div(x.detach(), voxel_size)) + 0.5) * voxel_size
        F = rows.shape[-1] // 8
        feats = interp_corner_features(x, center, rows.reshape(rows.shape[:-1] + (8, F)), voxel_size)
        feats = torch.where(valid[..., None], feats, 0.0)
        wrt = [x, rows] if want_dpacked else [x]
        grads = torch.autograd.grad(feats, wrt, dfeats)
    dpacked = None
    if want_dpacked:
        drows = grads[1] * valid[..., None]
        dpacked = torch.zeros_like(packed).index_add_(
            0, safe.reshape(-1), drows.reshape(-1, packed.shape[1]))
    return grads[0], dpacked


def hits_field_bwd(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked=True):
    """K2: K1's backward. d xyz (R, M, 3) from the trilinear-weight
    derivatives and, when ``want_dpacked``, the 8 x 16 corner gradients of
    every valid sample atomically added into a zeroed d packed (A, 128).
    Replaces the backward XLA emits for K1 under jax.value_and_grad
    (core/ba.py:335) and jax.grad (core/tracking.py:214). Bound: the
    packed-row read and 128 float atomics per valid sample."""
    if packed.device.type == "cpu":
        return hits_field_bwd_plain(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked)
    if packed.device.type != "cuda":
        raise ValueError(f"hits_field_bwd: unsupported device {packed.device}")
    global hits_field_bwd_launches
    dev = packed.device
    ins = [t.contiguous() for t in (dfeats.float(), xyz.float(), aid.to(torch.int32), valid,
                                     packed.float())]
    if any(t.device != dev for t in ins):
        raise ValueError("hits_field_bwd: all inputs must be on one device")
    n = xyz.shape[0] * xyz.shape[1]
    dxyz = torch.empty(xyz.shape, dtype=torch.float32, device=dev)
    dpacked = torch.zeros_like(ins[-1]) if want_dpacked else None
    err = kernels.lib().nl_hits_field_bwd(
        *[t.data_ptr() for t in ins], n, voxel_size, dxyz.data_ptr(),
        dpacked.data_ptr() if want_dpacked else None, kernels.stream_ptr(dev),
    )
    kernels.check(err, "hits_field_bwd")
    hits_field_bwd_launches += 1
    return dxyz, dpacked


class _HitsField(torch.autograd.Function):
    """feats = K1(packed, rays_o, rays_d); backward through K2."""

    @staticmethod
    def forward(ctx, packed, rays_o, rays_d, ht, u, voxel_size):
        z, valid, aid, xyz, feats = hits_field_fwd(ht, u, rays_o, rays_d, packed, voxel_size)
        ctx.save_for_backward(packed, z, valid, aid, xyz)
        ctx.voxel_size = voxel_size
        ctx.mark_non_differentiable(z, valid, aid, xyz)
        return feats, z, valid, aid, xyz

    @staticmethod
    def backward(ctx, dfeats, *_):
        packed, z, valid, aid, xyz = ctx.saved_tensors
        want_dpacked = ctx.needs_input_grad[0]
        dxyz, dpacked = hits_field_bwd(dfeats, xyz, aid, valid, packed, ctx.voxel_size,
                                       want_dpacked)
        d_o = dxyz.sum(1) if ctx.needs_input_grad[1] else None
        d_d = (z[..., None] * dxyz).sum(1) if ctx.needs_input_grad[2] else None
        return dpacked, d_o, d_d, None, None, None


def hits_field(packed, rays_o, rays_d, ht: HitTable, u, voxel_size):
    """Differentiable K1: (feats, z, valid, aid, xyz)."""
    return _HitsField.apply(packed, rays_o, rays_d, ht, u, voxel_size)


def render_rays_hits(packed, decoder_params, voxel_size: float, rays_o, rays_d, ht: HitTable,
                     ray_valid, jitter_u, compute_dtype=torch.float32) -> RenderOutput:
    """render_rays over a prebuilt HitTable: K1 -> decoder -> masked sdf.
    ``jitter_u`` (R, M) is the placement jitter (JAX draws it internally
    unless given; the port always takes it)."""
    feats, z, valid, _, xyz = hits_field(packed, rays_o, rays_d, ht, jitter_u, voxel_size)
    valid = valid & ray_valid[:, None]
    sdf = decoder_apply(decoder_params, feats, compute_dtype)[..., 0]
    sdf = torch.where(valid, sdf, 1.0)
    z_out = torch.where(valid, z, MAX_DEPTH)
    return RenderOutput(z_out, sdf, ht.ray_mask & ray_valid, valid, xyz)
