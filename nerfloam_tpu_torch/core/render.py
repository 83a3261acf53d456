"""Field evaluation of the hits sampler, the grid sampler and of explicit
sample depths (port of nerfloam_tpu/core/render.py:42-69, 72-150,
153-279).

``hits_field_fwd`` is kernel K1, ``hits_field_bwd`` kernel K2
(csrc/hits_field.cu) and ``active_field_fwd`` kernel K8
(csrc/active_field.cu) on CUDA tensors; on CPU tensors each takes its
plain torch twin. K1 places samples over a ray's hit table; K8 evaluates
given depths (the band and anchor columns of the quality stack, and the
surface-bias probe) through the dense active grid. ``field_columns`` wraps
K1 and K8 in one autograd Function over (packed, rays_o, rays_d): the
features of both column sets come out side by side, and the backward is
ONE K2 launch over all of them, mapped onto the rays (d o = sum d xyz,
d d = sum z d xyz, since xyz = o + d z with z fixed by the hit table, the
jitter or the band depth). K2 fits K8 too: it takes per-sample (xyz, aid,
valid) in the active index space and interpolates in the sample's own
cell, which is what K8 computes. The cell that resolves a sample and the
cell that interpolates it come from the same xyz, as in JAX. The grid
sampler's ``render_rays`` goes through the same Function: K9b
(ops/raycast.py) places the depths and K8 evaluates them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core.losses import MAX_DEPTH
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.models.decoder import decoder_apply
from nerfloam_tpu_torch.ops.interp import interp_corner_features
from nerfloam_tpu_torch.ops.raycast import (
    HitTable,
    RaycastConfig,
    cells_of,
    div,
    place_samples_cdf,
    resolve_cells_in_hits,
    sample_from_hits,
)

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
hits_field_fwd_launches = 0
hits_field_bwd_launches = 0
active_field_fwd_launches = 0

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
    derivatives and, when ``want_dpacked``, d packed (A, 128): the 8 x 16
    corner gradients of every valid sample, summed per packed row in
    ascending sample index. The samples are sorted by row here (a stable
    ``torch.sort`` and a ``searchsorted`` for the rows' segments) and the
    kernel's second pass adds each row's own samples in that order, so the
    table is bit-identical from run to run (no atomics). Replaces the
    backward XLA emits for K1 under jax.value_and_grad (core/ba.py:335) and
    jax.grad (core/tracking.py:214). Bound: the packed-row read per valid
    sample and the d packed write."""
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
    A = packed.shape[0]
    order = seg = dpacked = None
    if want_dpacked:
        key = torch.where(ins[3], ins[2], A).reshape(-1)  # invalid samples sort last
        skey, order = torch.sort(key, stable=True)
        seg = torch.searchsorted(skey, torch.arange(A + 1, dtype=torch.int32, device=dev))
        dpacked = torch.empty_like(ins[-1])
    err = kernels.lib().nl_hits_field_bwd(
        *[t.data_ptr() for t in ins], n, voxel_size, dxyz.data_ptr(),
        *[None if t is None else t.data_ptr() for t in (order, seg)], A,
        None if dpacked is None else dpacked.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(err, "hits_field_bwd")
    hits_field_bwd_launches += 1
    return dxyz, dpacked


# ---------------------------------------------------------------- K8


def active_field_fwd_plain(state: vm.MapState, map_cfg: vm.MapConfig, packed, rays_o, rays_d, z,
                           ray_valid, xyz=None):
    """Plain torch twin of K8: (aid, valid, xyz, feats) per sample."""
    vs = map_cfg.voxel_size
    if xyz is None:
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    aid = vm.lookup_active(state, map_cfg, cells_of(xyz, vs))
    valid = (aid >= 0) & ray_valid[:, None] & (z > 0)
    rows = packed[torch.clamp(aid, min=0).long()]
    feats = torch.where(valid[..., None], interp_packed(xyz, rows, vs), 0.0)
    return torch.where(valid, aid, -1), valid, xyz, feats


def active_field_fwd(state: vm.MapState, map_cfg: vm.MapConfig, packed, rays_o, rays_d, z,
                     ray_valid, xyz=None):
    """K8: field features at explicit depths z (R, K) along rays (R, 3), or
    at given points ``xyz`` (R, K, 3) with rays_o = rays_d = None (z then
    only gates z > 0): the cell's active id from ``state.grid_active``
    (-1 outside the region), valid = aid >= 0 & ray_valid (R,) & z > 0, one
    packed row and trilinear features. Replaces the XLA fusion of
    nerfloam_tpu/core/render.py:181-202 (band_samples) and 42-69
    (field_at) up to the decoder. Bound: one 512 B packed row per valid
    sample (see csrc/active_field.cu). Returns (aid, valid, xyz, feats)."""
    if packed.device.type == "cpu":
        return active_field_fwd_plain(state, map_cfg, packed, rays_o, rays_d, z, ray_valid, xyz)
    if packed.device.type != "cuda":
        raise ValueError(f"active_field_fwd: unsupported device {packed.device}")
    global active_field_fwd_launches
    dev = packed.device
    R, K = z.shape
    if packed.shape[1] != 128:
        raise ValueError("active_field_fwd: packed rows must be 8 x 16 floats")
    if xyz is None:
        o, d, x_in = rays_o.float().contiguous(), rays_d.float().contiguous(), None
    else:
        o = d = None
        x_in = xyz.float().reshape(R, K, 3).contiguous()
    ins = [t for t in (o, d, x_in) if t is not None] + [
        z.float().contiguous(), ray_valid.to(torch.bool).contiguous(),
        state.grid_active.contiguous(), state.region_min.to(torch.int32).contiguous(),
        packed.float().contiguous()]
    if any(t.device != dev for t in ins):
        raise ValueError("active_field_fwd: all inputs must be on one device")
    zz, rv, ga, rmin, pk = ins[-5:]
    aid = torch.empty((R, K), dtype=torch.int32, device=dev)
    valid = torch.empty((R, K), dtype=torch.bool, device=dev)
    xyz_out = torch.empty((R, K, 3), dtype=torch.float32, device=dev)
    feats = torch.empty((R, K, 16), dtype=torch.float32, device=dev)
    Dx, Dy, Dz = map_cfg.grid_dim
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = kernels.lib().nl_active_field_fwd(
        p(o), p(d), p(zz), p(x_in), p(rv), p(ga), p(rmin), Dx, Dy, Dz, p(pk), R, K,
        map_cfg.voxel_size, p(aid), p(valid), p(xyz_out), p(feats), kernels.stream_ptr(dev))
    kernels.check(err, "active_field_fwd")
    active_field_fwd_launches += 1
    return aid, valid, xyz_out, feats


def band_sample_z(depth, cos, truncation: float, n: int, u):
    """(R, n) stratified depths across the cosine-widened truncation band
    around the measured distance: z = d + ((i + u) / n * 2 - 1) T / cos."""
    off = div(torch.arange(n, dtype=torch.float32, device=depth.device) + u, float(n)) * 2.0 - 1.0
    half = truncation / torch.clamp(cos, min=0.05)
    return depth[:, None] + off * half[:, None]


def extra_surface_z(dnorm, pcos, truncation: float, n_anchor: int, n_band: int, band_u=None):
    """(R, n_anchor + n_band) depths of the anchor columns (the measured
    distance, repeated as its weight) and the band columns
    (render.py:205-239 extra_surface_columns, up to the field)."""
    cols = []
    if n_anchor:
        cols.append(dnorm[:, None].expand(-1, n_anchor))
    if n_band:
        cols.append(band_sample_z(dnorm, pcos, truncation, n_band, band_u))
    return torch.cat(cols, 1)


# ------------------------------------------------------- K1 + K8 columns


def _append_extra(out, packed, rays_o, rays_d, extra):
    """K8 at the extra depths of ``extra = (state, map_cfg, ez, ray_valid)``
    (R, K), its columns after the sampler's."""
    if extra is None:
        return out
    state, map_cfg, ez, ray_valid = extra
    eaid, evalid, exyz, efeats = active_field_fwd(state, map_cfg, packed, rays_o, rays_d, ez,
                                                  ray_valid)
    return tuple(torch.cat(p, 1) for p in zip(out, (ez, evalid, eaid, exyz, efeats)))


def columns_fwd(ht: HitTable, u, rays_o, rays_d, packed, voxel_size, extra=None):
    """K1 over the hit table and, when ``extra = (state, map_cfg, ez,
    ray_valid)``, K8 at the extra depths ez (R, K): (z, valid, aid, xyz,
    feats) with the K columns after the M hits columns."""
    out = hits_field_fwd(ht, u, rays_o, rays_d, packed, voxel_size)
    return _append_extra(out, packed, rays_o, rays_d, extra)


def grid_columns_fwd(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig, occupancy,
                     u, rays_o, rays_d, t_cap, packed, extra=None):
    """The grid sampler's columns: K9b places the samples over the hoisted
    ``occupancy = (cdf, n_occ)`` (K9a) at the current rays, K8 evaluates
    their features at those depths, and ``extra`` appends K8's columns as
    in columns_fwd. Returns ((z, valid, aid, xyz, feats), ray_mask).
    Validity is K9b's: K8 agrees on it (its cell is the same floor of the
    same xyz, and K9b zeroes the depth of every invalid sample), so its
    features are zero exactly where K9b marks a sample invalid."""
    z, aid, valid, ray_mask = place_samples_cdf(state, map_cfg, rc, occupancy[0], occupancy[1],
                                                rays_o, rays_d, t_cap, u)
    _, _, xyz, feats = active_field_fwd(state, map_cfg, packed, rays_o, rays_d, z, ray_mask)
    return _append_extra((z, valid, aid, xyz, feats), packed, rays_o, rays_d, extra), ray_mask


class _FieldColumns(torch.autograd.Function):
    """feats = fwd(packed, rays_o, rays_d)[4] for a column producer ``fwd``
    returning (z, valid, aid, xyz, feats); backward: one K2 over all
    columns, mapped onto the rays (z carries no gradient)."""

    @staticmethod
    def forward(ctx, packed, rays_o, rays_d, fwd, voxel_size):
        z, valid, aid, xyz, feats = fwd(packed, rays_o, rays_d)
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
        return dpacked, d_o, d_d, None, None


def field_columns(packed, rays_o, rays_d, ht: HitTable, u, voxel_size, extra=None):
    """Differentiable K1 (+ K8 columns): (feats, z, valid, aid, xyz)."""
    return _FieldColumns.apply(
        packed, rays_o, rays_d,
        lambda p, o, d: columns_fwd(ht, u, o, d, p, voxel_size, extra), voxel_size)


def _render_out(decoder_params, feats, z, valid, xyz, ray_mask, ray_valid, compute_dtype):
    valid = valid & ray_valid[:, None]
    sdf = decoder_apply(decoder_params, feats, compute_dtype)[..., 0]
    sdf = torch.where(valid, sdf, 1.0)
    z_out = torch.where(valid, z, MAX_DEPTH)
    return RenderOutput(z_out, sdf, ray_mask & ray_valid, valid, xyz)


def render_rays_hits(packed, decoder_params, voxel_size: float, rays_o, rays_d, ht: HitTable,
                     ray_valid, jitter_u, compute_dtype=torch.float32,
                     extra=None) -> RenderOutput:
    """render_rays over a prebuilt HitTable: K1 -> decoder -> masked sdf.
    ``jitter_u`` (R, M) is the placement jitter (JAX draws it internally
    unless given; the port always takes it). ``extra = (state, map_cfg,
    ez, ray_valid)`` appends K8's columns at depths ez (R, K), i.e. JAX's
    extra_surface_columns concatenated onto the render output (ba.py:
    282-304); one decoder call and one K2 take both."""
    feats, z, valid, _, xyz = field_columns(packed, rays_o, rays_d, ht, jitter_u, voxel_size,
                                            extra)
    return _render_out(decoder_params, feats, z, valid, xyz, ht.ray_mask, ray_valid,
                       compute_dtype)


def render_rays(packed, decoder_params, state: vm.MapState, map_cfg: vm.MapConfig,
                rc: RaycastConfig, rays_o, rays_d, t_cap, ray_valid, occupancy, jitter_u,
                compute_dtype=torch.float32, extra=None) -> RenderOutput:
    """render_rays with the grid sampler (nerfloam_tpu/core/render.py:
    242-279, the march hoisted: ``occupancy = (cdf, n_occ)`` from K9a):
    K9b -> K8 at its depths (+ K8's ``extra`` columns) -> decoder -> masked
    sdf. ``packed`` is the differentiable table (BA's optimized copy);
    lookups go through ``state``'s grid. The backward is one K2 launch;
    the depths depend only on the cdf and ``jitter_u``, so the rays' (and
    the pose's) gradient flows through xyz = o + d z alone, as in JAX."""
    side = {}

    def fwd(p, o, d):
        out, side["ray_mask"] = grid_columns_fwd(state, map_cfg, rc, occupancy, jitter_u, o, d,
                                                 t_cap, p, extra)
        return out

    feats, z, valid, _, xyz = _FieldColumns.apply(packed, rays_o, rays_d, fwd,
                                                  map_cfg.voxel_size)
    return _render_out(decoder_params, feats, z, valid, xyz, side["ray_mask"], ray_valid,
                       compute_dtype)


def field_at_points(state: vm.MapState, map_cfg: vm.MapConfig, packed, decoder_params, xyz,
                    z, point_valid, compute_dtype=torch.float32):
    """sdf at world points xyz (R, K, 3) in active voxels (JAX field_at with
    its lookup_active): K8 with given points, then the decoder. ``z`` and
    ``point_valid`` (R,) gate validity as in active_field_fwd. Returns
    (sdf, valid); sdf is 0 where not valid."""
    _, valid, _, feats = active_field_fwd(state, map_cfg, packed, None, None, z, point_valid, xyz)
    sdf = decoder_apply(decoder_params, feats, compute_dtype)[..., 0]
    return torch.where(valid, sdf, 0.0), valid
