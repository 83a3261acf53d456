"""Field evaluation of the hits sampler, the grid sampler and of explicit
sample depths (port of nerfloam_tpu/core/render.py:42-69, 72-150,
153-279).

``hits_field_fwd`` is kernel K1, ``hits_field_bwd`` kernel K2
(csrc/hits_field.cu) and ``ActiveField`` (made once over a map, one a
tracker's frame or a BA step; ``active_field_fwd`` is one call of a fresh
one) kernel K8 (csrc/active_field.cu) on CUDA tensors; on CPU tensors each
takes its plain torch twin. K1 places samples over a ray's hit table; K8 evaluates
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
from nerfloam_tpu_torch.models.decoder import PLAIN, DecoderMeta, decoder_apply
from nerfloam_tpu_torch.ops.interp import interp_corner_features
from nerfloam_tpu_torch.ops.raycast import (
    _ORIGIN_STRIDES,
    CdfPlacer,
    HitTable,
    cells_of,
    div,
    rdiv,
    resolve_cells_in_hits,
    sample_from_hits,
)

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
hits_field_fwd_launches = 0
hits_field_bwd_launches = 0
active_field_fwd_launches = 0

_JITTER_LO, _JITTER_HI = 1e-4, 1.0 - 1e-4  # frac clip of sample_from_hits
_FWD, _BWD, _K8 = "hits_field_fwd", "hits_field_bwd", "active_field_fwd"
_F32 = torch.float32
_K1_SMEM_MAX = 227 * 1024  # an H100 block's shared memory; K1 stages a ray's tables there


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


def _check_fwd(ht: HitTable, u, rays_o, rays_d, packed):
    """K1's inputs as the kernel reads them, or ValueError. Returns (R, H,
    M, the row stride of t_near / seg / cdf, rays_o's row stride)."""
    dev = packed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{_FWD}: unsupported device {dev}")
    kernels.expect(_FWD, dev, torch.int32, aid=ht.aid, cell=ht.cell)
    kernels.expect(_FWD, dev, _F32, u=u, rays_d=rays_d, packed=packed)
    R, H = ht.aid.shape
    M = u.shape[-1]
    kernels.expect_shape(_FWD, cell=(ht.cell, (R, H, 3)), u=(u, (R, M)), rays_d=(rays_d, (R, 3)),
                         packed=(packed, (packed.shape[0], 128)))
    # t_near, seg and cdf may be views of one wider table (BA unpacks its
    # hit table from one (R, 7H) row per ray): rows of H, one row stride
    ld = ht.cdf.stride(0) if R > 1 else H
    for label, t in (("t_near", ht.t_near), ("seg", ht.seg), ("cdf", ht.cdf)):
        if (t.dtype != _F32 or t.device != dev or t.shape != (R, H) or t.stride(1) != 1
                or (R > 1 and t.stride(0) != ld) or ld < H):
            raise ValueError(f"{_FWD}: {label} must be ({R}, {H}) f32 rows on {dev}, with the row "
                             f"stride of cdf; got {tuple(t.shape)} {t.dtype}, strides "
                             f"{tuple(t.stride())}, on {t.device}")
    if 4 * (7 * (H + M) + 6) > _K1_SMEM_MAX:
        raise ValueError(f"{_FWD}: a ray of {H} hit slots and {M} samples needs more shared "
                         f"memory than a block has ({_K1_SMEM_MAX} B)")
    return R, H, M, ld, kernels.expect_origin(_FWD, dev, rays_o, R)


def hits_field_fwd(ht: HitTable, u, rays_o, rays_d, packed, voxel_size):
    """K1: stratified placement over the hit table, in-register voxel
    re-resolution, one packed row and trilinear features per sample.
    Replaces the XLA fusion of nerfloam_tpu/core/render.py:132-147 over
    ops/raycast.py:248-324, render.py:91-105 and interp.py:22-47 (up to the
    decoder). Bound: one 512 B packed row read per valid sample (see
    csrc/hits_field.cu). Returns (z, valid, aid, xyz, feats).

    Every input must already be what the kernel reads (int32 aid and
    cells, f32 otherwise, contiguous, on packed's device; t_near / seg /
    cdf may share a row stride wider than H; ``rays_o`` may be one origin
    expanded, row stride 0): nothing is converted or copied, and a tensor
    that would need it raises ValueError, on the CPU too. CPU tensors take
    ``hits_field_fwd_plain``; CUDA tensors launch the kernel once."""
    R, H, M, ld, o_st = _check_fwd(ht, u, rays_o, rays_d, packed)
    if packed.device.type == "cpu":
        return hits_field_fwd_plain(ht, u, rays_o, rays_d, packed, voxel_size)
    global hits_field_fwd_launches
    dev = packed.device
    z = torch.empty((R, M), dtype=_F32, device=dev)
    valid = torch.empty((R, M), dtype=torch.bool, device=dev)
    aid = torch.empty((R, M), dtype=torch.int32, device=dev)
    xyz = torch.empty((R, M, 3), dtype=_F32, device=dev)
    feats = torch.empty((R, M, 16), dtype=_F32, device=dev)
    err = kernels.lib().nl_hits_field_fwd(
        ht.aid.data_ptr(), ht.t_near.data_ptr(), ht.seg.data_ptr(), ht.cdf.data_ptr(), ld,
        ht.cell.data_ptr(), u.data_ptr(), rays_o.data_ptr(), o_st, rays_d.data_ptr(),
        packed.data_ptr(), R, M, H, voxel_size, _JITTER_LO, _JITTER_HI, z.data_ptr(),
        valid.data_ptr(), aid.data_ptr(), xyz.data_ptr(), feats.data_ptr(),
        kernels.stream_ptr(dev))
    if err:
        kernels.check(err, _FWD)
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


def dpacked_in_row_order_plain(dfeats, xyz, aid, valid, n_rows: int, voxel_size):
    """d packed (n_rows, 128) in K2's own arithmetic, the kernel's bit-exact
    oracle (tests and chip_smoke.py; no run calls it). Per valid sample
    the 8 trilinear weights by the elementwise f32 ops of the kernel
    (p = (xyz - center) / vs + 0.5 with center = (floor(xyz / vs) + 0.5)
    vs, w_j = (f_x f_y) f_z, f = 1 - p or p), then per row, from 0, the
    contributions w_j * dfeats added in ascending sample index: one pass
    per rank within a row's samples, each pass one add on every row that
    has a sample of that rank."""
    F = dfeats.shape[-1]
    ids = torch.nonzero(valid.reshape(-1)).reshape(-1)  # ascending
    rows, order = torch.sort(aid.reshape(-1)[ids].long(), stable=True)
    ids = ids[order]
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    pos = torch.arange(len(rows), device=rows.device)
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    x = xyz.reshape(-1, 3)[ids]
    center = (torch.floor(div(x, voxel_size)) + 0.5) * voxel_size
    p = div(x - center, voxel_size) + 0.5
    f = torch.stack([1.0 - p, p], -1)  # (S, 3 axes, 2)
    bits = torch.as_tensor([[(j >> 2) & 1, (j >> 1) & 1, j & 1] for j in range(8)],
                           device=x.device)
    w = (f[:, 0, bits[:, 0]] * f[:, 1, bits[:, 1]]) * f[:, 2, bits[:, 2]]  # (S, 8)
    contrib = w[:, :, None] * dfeats.reshape(-1, F)[ids][:, None, :]      # (S, 8, F)
    out = torch.zeros((n_rows, 8, F), dtype=torch.float32, device=dfeats.device)
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = rank == r
        out[rows[sel]] = out[rows[sel]] + contrib[sel]
    return out.reshape(n_rows, 8 * F)


class DpackedScratch:
    """K2's d-packed scratch, owned by its caller: a BA step makes one and
    hands it to every render of the step (render_rays_hits / render_rays
    ``scratch=``), so its calls, on one stream, take turns with it. It
    holds the scan's tile states and its ticket (int64, the ticket last),
    the per-row sample counts, the row offsets, the grouped sample indices,
    the per-sample trilinear weights, and the lists of touched rows behind
    their two counters. It is allocated at its first call on the card, and
    again only for a call with more rows or samples. States, ticket and
    counts start at zero and every call leaves them at zero (the scatter
    counts each row back down), so no call needs a memset; a call whose
    launch fails drops the buffers, and the next call starts afresh."""

    def __init__(self):
        self.drop()

    def fit(self, dev, A: int, n: int):
        """The kernels' scratch pointers for A rows and n samples on dev."""
        if self.ptrs is None or A > self.A or n > self.n or dev != self.dev:
            A, n = max(A, self.A), max(n, self.n, 1)
            tiles = kernels.lib().nl_hits_field_scan_tiles(A)
            state = torch.zeros((tiles + 1,), dtype=torch.int64, device=dev)
            self._bufs = (state,
                          torch.zeros((A,), dtype=torch.int32, device=dev),       # counts
                          torch.empty((A + 1,), dtype=torch.int32, device=dev),   # offsets
                          torch.empty((n,), dtype=torch.int32, device=dev),       # ids
                          torch.empty((n, 8), dtype=_F32, device=dev),            # weights
                          torch.zeros((2 + 2 * A,), dtype=torch.int32, device=dev))  # row lists
            self.A, self.n, self.dev = A, n, dev
            self.ptrs = (state.data_ptr(), state.data_ptr() + 8 * tiles,
                         *[t.data_ptr() for t in self._bufs[1:]])
        return self.ptrs

    def drop(self):
        self.A = self.n = 0
        self.dev = self.ptrs = self._bufs = None


_NO_SCRATCH = (None,) * 7


def _check_bwd(dfeats, xyz, aid, valid, packed):
    """K2's inputs as the kernels read them, or ValueError."""
    dev = packed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{_BWD}: unsupported device {dev}")
    kernels.expect(_BWD, dev, _F32, dfeats=dfeats, xyz=xyz, packed=packed)
    kernels.expect(_BWD, dev, torch.int32, aid=aid)
    kernels.expect(_BWD, dev, torch.bool, valid=valid)
    S = tuple(valid.shape)
    kernels.expect_shape(_BWD, dfeats=(dfeats, S + (16,)), xyz=(xyz, S + (3,)), aid=(aid, S),
                         packed=(packed, (packed.shape[0], 128)))


def hits_field_bwd(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked=True,
                   scratch: DpackedScratch | None = None):
    """K2: K1's (and K8's) backward. d xyz (R, M, 3) from the trilinear-weight
    derivatives and, when ``want_dpacked``, d packed (A, 128): the 8 x 16
    corner gradients of every valid sample, summed per packed row in
    ascending sample index, from 0, so the table is bit-identical from run
    to run (no float atomics) and equal to ``dpacked_in_row_order_plain``.
    On the card the d xyz form is one launch; the d packed form four (the
    sample pass counts the samples per row, a one-pass scan gives the rows'
    segments, a scatter fills them, one warp per row sorts its segment and
    adds it) and no torch op, through ``scratch`` (a ``DpackedScratch``;
    without one, a scratch made for this call alone, whose allocations
    and zeros add their own launches). Replaces the backward XLA emits for
    K1 under jax.value_and_grad (core/ba.py:335) and jax.grad
    (core/tracking.py:214). Bound: the packed-row read per valid sample and
    the d packed write.

    Every input must already be what the kernels read (f32 dfeats (R, M,
    16), xyz and packed (A, 128), int32 aid, bool valid, contiguous, on one
    device): a tensor that would need a conversion raises ValueError, on
    the CPU too. CPU tensors take ``hits_field_bwd_plain``."""
    _check_bwd(dfeats, xyz, aid, valid, packed)
    if packed.device.type == "cpu":
        return hits_field_bwd_plain(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked)
    global hits_field_bwd_launches
    dev = packed.device
    n, A = valid.numel(), packed.shape[0]
    dxyz = torch.empty(xyz.shape, dtype=_F32, device=dev)
    dpacked, ptrs = None, _NO_SCRATCH
    if want_dpacked:
        dpacked = torch.empty_like(packed)
        scratch = DpackedScratch() if scratch is None else scratch
        ptrs = scratch.fit(dev, A, n)
    err = kernels.lib().nl_hits_field_bwd(
        dfeats.data_ptr(), xyz.data_ptr(), aid.data_ptr(), valid.data_ptr(), packed.data_ptr(), n,
        voxel_size, dxyz.data_ptr(), A, None if dpacked is None else dpacked.data_ptr(), *ptrs,
        kernels.stream_ptr(dev))
    if err:
        if want_dpacked:
            scratch.drop()  # its counts may not be zero
        kernels.check(err, _BWD)
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


class ActiveField:
    """K8 prepared for a span over one map: the dense active grid
    (``state.grid_active``, int32 (Dx*Dy*Dz,), and ``state.region_min``,
    int32 (3,)), its dims and the voxel size are checked once; each call
    ``field(packed, rays_o, rays_d, z, ray_valid, xyz=None)`` checks only
    its own inputs and, on the card, makes one launch. A tracker makes one
    per frame, a BA step one per step (the grid is fixed over both; the
    packed table is the call's: BA's optimized copy, or the reconciled one
    the bias probe reads).

    Per call: depths z (R, K) along rays (R, 3), or given points ``xyz``
    (R, K, 3) with rays_o = rays_d = None (z then only gates z > 0); the
    cell's active id (-1 outside the region), valid = aid >= 0 & ray_valid
    (R,) & z > 0, one packed row (A, 128) and trilinear features. Returns
    (aid, valid, xyz, feats), fresh tensors. Every input must already be
    what the kernel reads (f32, bool ray_valid, contiguous, on the grid's
    device; ``rays_o`` may be one origin expanded, row stride 0): nothing is
    converted or copied, and a tensor that would need it raises ValueError,
    on the CPU too. CPU tensors take ``active_field_fwd_plain``."""

    def __init__(self, state: vm.MapState, map_cfg: vm.MapConfig):
        ga, rmin = state.grid_active, state.region_min
        dev = ga.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{_K8}: unsupported device {dev}")
        kernels.expect(_K8, dev, torch.int32, grid_active=ga, region_min=rmin)
        Dx, Dy, Dz = map_cfg.grid_dim
        kernels.expect_shape(_K8, grid_active=(ga, (Dx * Dy * Dz,)), region_min=(rmin, (3,)))
        self.state, self.map_cfg, self.device = state, map_cfg, dev
        self.voxel_size = map_cfg.voxel_size
        self._index = -2  # matches no tensor's get_device(): CPU calls take the full checks
        if dev.type == "cuda":
            self._index = ga.get_device()
            self._launch = kernels.lib().nl_active_field_fwd
            self._grid = (ga.data_ptr(), rmin.data_ptr(), Dx, Dy, Dz)

    def __call__(self, packed, rays_o, rays_d, z, ray_valid, xyz=None):
        index = self._index
        # the rays' form on the card in one expression (each term a fraction
        # of a us); the probe's form, anything else and every CPU call go
        # through the full checks, which raise
        if (xyz is None and z.dtype is _F32 and rays_d.dtype is _F32 and rays_o.dtype is _F32
                and ray_valid.dtype is torch.bool and packed.dtype is _F32
                and len(zs := z.shape) == 2 and rays_d.shape == (zs[0], 3)
                and rays_o.shape == rays_d.shape and ray_valid.shape == zs[:1]
                and z.is_contiguous() and rays_d.stride() == (3, 1)
                and (o_st := rays_o.stride()) in _ORIGIN_STRIDES and ray_valid.is_contiguous()
                and packed.is_contiguous() and packed.shape[1] == 128
                and z.get_device() == index and rays_d.get_device() == index
                and rays_o.get_device() == index and ray_valid.get_device() == index
                and packed.get_device() == index and (pk := packed.data_ptr()) & 15 == 0):
            o_st = o_st[0]
        else:
            o_st = self._check(packed, rays_o, rays_d, z, ray_valid, xyz)
            if index < 0:
                return active_field_fwd_plain(self.state, self.map_cfg, packed, rays_o, rays_d,
                                              z, ray_valid, xyz)
            pk = packed.data_ptr()
        global active_field_fwd_launches
        dev = self.device
        R, K = z.shape
        aid = torch.empty((R, K), dtype=torch.int32, device=dev)
        valid = torch.empty((R, K), dtype=torch.bool, device=dev)
        xyz_out = torch.empty((R, K, 3), dtype=_F32, device=dev)
        feats = torch.empty((R, K, 16), dtype=_F32, device=dev)
        rays = ((None, 0, None, xyz.data_ptr()) if xyz is not None
                else (rays_o.data_ptr(), o_st, rays_d.data_ptr(), None))
        err = self._launch(
            *rays[:3], z.data_ptr(), rays[3], ray_valid.data_ptr(), *self._grid, pk, R, K,
            self.voxel_size, aid.data_ptr(), valid.data_ptr(), xyz_out.data_ptr(),
            feats.data_ptr(), kernels.raw_stream(index))
        if err:
            kernels.check(err, _K8)
        active_field_fwd_launches += 1
        return aid, valid, xyz_out, feats

    def _check(self, packed, rays_o, rays_d, z, ray_valid, xyz):
        """The full checks, raising ValueError; returns rays_o's row stride."""
        dev = self.device
        kernels.expect(_K8, dev, _F32, z=z, packed=packed)
        kernels.expect(_K8, dev, torch.bool, ray_valid=ray_valid)
        if z.dim() != 2:
            raise ValueError(f"{_K8}: z has shape {tuple(z.shape)}, expected (R, K)")
        R, K = z.shape
        kernels.expect_shape(_K8, ray_valid=(ray_valid, (R,)),
                             packed=(packed, (packed.shape[0], 128)))
        if packed.data_ptr() % 16:
            raise ValueError(f"{_K8}: packed must start on a 16-byte boundary (float4 rows)")
        if xyz is not None:
            if rays_o is not None or rays_d is not None:
                raise ValueError(f"{_K8}: given points take rays_o = rays_d = None")
            kernels.expect(_K8, dev, _F32, xyz=xyz)
            kernels.expect_shape(_K8, xyz=(xyz, (R, K, 3)))
            return 0
        kernels.expect(_K8, dev, _F32, rays_d=rays_d)
        kernels.expect_shape(_K8, rays_d=(rays_d, (R, 3)))
        return kernels.expect_origin(_K8, dev, rays_o, R)


def active_field_fwd(state: vm.MapState, map_cfg: vm.MapConfig, packed, rays_o, rays_d, z,
                     ray_valid, xyz=None):
    """K8: one call of an ``ActiveField`` made for it (see there: inputs are
    checked, never converted). Replaces the XLA fusion of
    nerfloam_tpu/core/render.py:181-202 (band_samples) and 42-69 (field_at)
    up to the decoder. Bound: one 512 B packed row per valid sample (see
    csrc/active_field.cu). Returns (aid, valid, xyz, feats)."""
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_K8}: unsupported device {packed.device}")
    return ActiveField(state, map_cfg)(packed, rays_o, rays_d, z, ray_valid, xyz)


def band_sample_z(depth, cos, truncation: float, n: int, u):
    """(R, n) stratified depths across the cosine-widened truncation band
    around the measured distance: z = d + ((i + u) / n * 2 - 1) T / cos."""
    off = div(torch.arange(n, dtype=torch.float32, device=depth.device) + u, float(n)) * 2.0 - 1.0
    half = rdiv(truncation, torch.clamp(cos, min=0.05))
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
    """K8 at the extra depths of ``extra = (field, ez, ray_valid)`` (an
    ``ActiveField``, depths (R, K), (R,)), its columns after the sampler's."""
    if extra is None:
        return out
    field, ez, ray_valid = extra
    eaid, evalid, exyz, efeats = field(packed, rays_o, rays_d, ez, ray_valid)
    return tuple(torch.cat(p, 1) for p in zip(out, (ez, evalid, eaid, exyz, efeats)))


def columns_fwd(ht: HitTable, u, rays_o, rays_d, packed, voxel_size, extra=None):
    """K1 over the hit table and, when ``extra = (field, ez, ray_valid)``,
    K8 (an ``ActiveField``) at the extra depths ez (R, K): (z, valid, aid,
    xyz, feats) with the K columns after the M hits columns."""
    out = hits_field_fwd(ht, u, rays_o, rays_d, packed, voxel_size)
    return _append_extra(out, packed, rays_o, rays_d, extra)


def grid_columns_fwd(field: ActiveField, placer: CdfPlacer, u, rays_o, rays_d, packed, extra=None,
                     rows=None):
    """The grid sampler's columns: K9b places the samples at the current
    rays through ``placer`` (a ``raycast.CdfPlacer`` over K9a's hoisted
    cdf; ``rows`` picks each ray's cdf row, as BA does), K8 (``field``, an
    ``ActiveField`` over the same map) evaluates their features at those
    depths, and ``extra`` appends K8's columns as in columns_fwd. Returns
    ((z, valid, aid, xyz, feats), ray_mask).
    Validity is K9b's: K8 agrees on it (its cell is the same floor of the
    same xyz, and K9b zeroes the depth of every invalid sample), so its
    features are zero exactly where K9b marks a sample invalid."""
    z, aid, valid, ray_mask = placer(rays_o, rays_d, u, rows)
    _, _, xyz, feats = field(packed, rays_o, rays_d, z, ray_mask)
    return _append_extra((z, valid, aid, xyz, feats), packed, rays_o, rays_d, extra), ray_mask


class _FieldColumns(torch.autograd.Function):
    """feats = fwd(packed, rays_o, rays_d)[4] for a column producer ``fwd``
    returning (z, valid, aid, xyz, feats); backward: one K2 over all
    columns, mapped onto the rays (z carries no gradient)."""

    @staticmethod
    def forward(ctx, packed, rays_o, rays_d, fwd, voxel_size, scratch):
        z, valid, aid, xyz, feats = fwd(packed, rays_o, rays_d)
        ctx.save_for_backward(packed, z, valid, aid, xyz)
        ctx.voxel_size, ctx.scratch = voxel_size, scratch
        ctx.mark_non_differentiable(z, valid, aid, xyz)
        return feats, z, valid, aid, xyz

    @staticmethod
    def backward(ctx, dfeats, *_):
        packed, z, valid, aid, xyz = ctx.saved_tensors
        # the one conversion on K2's way: autograd may hand a broadcast
        # gradient (a sum's ones expanded), which K2 reads as it is not
        dfeats = dfeats.contiguous()
        want_dpacked = ctx.needs_input_grad[0]
        dxyz, dpacked = hits_field_bwd(dfeats, xyz, aid, valid, packed, ctx.voxel_size,
                                       want_dpacked, ctx.scratch)
        d_o = dxyz.sum(1) if ctx.needs_input_grad[1] else None
        d_d = (z[..., None] * dxyz).sum(1) if ctx.needs_input_grad[2] else None
        return dpacked, d_o, d_d, None, None, None


def field_columns(packed, rays_o, rays_d, ht: HitTable, u, voxel_size, extra=None, scratch=None):
    """Differentiable K1 (+ K8 columns): (feats, z, valid, aid, xyz).
    ``scratch``: K2's ``DpackedScratch`` where packed's gradient is taken."""
    return _FieldColumns.apply(
        packed, rays_o, rays_d,
        lambda p, o, d: columns_fwd(ht, u, o, d, p, voxel_size, extra), voxel_size, scratch)


def _render_out(decoder_params, feats, z, valid, xyz, ray_mask, ray_valid, compute_dtype,
                dec_meta: DecoderMeta):
    valid = valid & ray_valid[:, None]
    sdf = decoder_apply(decoder_params, feats, compute_dtype, dec_meta)[..., 0]
    sdf = torch.where(valid, sdf, 1.0)
    z_out = torch.where(valid, z, MAX_DEPTH)
    return RenderOutput(z_out, sdf, ray_mask & ray_valid, valid, xyz)


def render_rays_hits(packed, decoder_params, voxel_size: float, rays_o, rays_d, ht: HitTable,
                     ray_valid, jitter_u, compute_dtype=torch.float32,
                     extra=None, scratch=None, dec_meta: DecoderMeta = PLAIN) -> RenderOutput:
    """render_rays over a prebuilt HitTable: K1 -> decoder -> masked sdf.
    ``jitter_u`` (R, M) is the placement jitter (JAX draws it internally
    unless given; the port always takes it). ``extra = (field, ez,
    ray_valid)`` appends K8's columns (``field``, an ``ActiveField``) at
    depths ez (R, K), i.e. JAX's
    extra_surface_columns concatenated onto the render output (ba.py:
    282-304); one decoder call and one K2 take both. ``scratch``: K2's
    ``DpackedScratch`` (BA's, made once a step); ``dec_meta`` the
    decoder's skips and embedder."""
    feats, z, valid, _, xyz = field_columns(packed, rays_o, rays_d, ht, jitter_u, voxel_size,
                                            extra, scratch)
    return _render_out(decoder_params, feats, z, valid, xyz, ht.ray_mask, ray_valid,
                       compute_dtype, dec_meta)


def render_rays(packed, decoder_params, field: ActiveField, rays_o, rays_d, ray_valid,
                placer: CdfPlacer, jitter_u, compute_dtype=torch.float32, extra=None, rows=None,
                scratch=None, dec_meta: DecoderMeta = PLAIN) -> RenderOutput:
    """render_rays with the grid sampler (nerfloam_tpu/core/render.py:
    242-279, the march hoisted: ``placer`` is a ``raycast.CdfPlacer`` over
    K9a's cdf, ``rows`` each ray's row in it where the rays are a subset):
    K9b -> K8 at its depths (+ K8's ``extra`` columns) -> decoder -> masked
    sdf. ``packed`` is the differentiable table (BA's optimized copy);
    lookups go through ``field``, an ``ActiveField`` over the map's grid
    (a tracker's, one a frame; BA's, one a step). The backward is one K2 launch;
    the depths depend only on the cdf and ``jitter_u``, so the rays' (and
    the pose's) gradient flows through xyz = o + d z alone, as in JAX.
    ``scratch``: K2's ``DpackedScratch`` (BA's, made once a step)."""
    side = {}

    def fwd(p, o, d):
        out, side["ray_mask"] = grid_columns_fwd(field, placer, jitter_u, o, d, p, extra, rows)
        return out

    feats, z, valid, _, xyz = _FieldColumns.apply(packed, rays_o, rays_d, fwd, field.voxel_size,
                                                  scratch)
    return _render_out(decoder_params, feats, z, valid, xyz, side["ray_mask"], ray_valid,
                       compute_dtype, dec_meta)


def field_at_points(field: ActiveField, packed, decoder_params, xyz, z, point_valid,
                    compute_dtype=torch.float32, dec_meta: DecoderMeta = PLAIN):
    """sdf at world points xyz (R, K, 3) in active voxels (JAX field_at with
    its lookup_active): K8 (``field``, an ``ActiveField``) with given
    points, then the decoder. ``z`` and ``point_valid`` (R,) gate validity
    as in ActiveField. Returns (sdf, valid); sdf is 0 where not valid."""
    _, valid, _, feats = field(packed, None, None, z, point_valid, xyz)
    sdf = decoder_apply(decoder_params, feats, compute_dtype, dec_meta)[..., 0]
    return torch.where(valid, sdf, 0.0), valid
