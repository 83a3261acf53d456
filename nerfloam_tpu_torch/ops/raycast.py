"""Ray sampling against the voxel map (port of nerfloam_tpu/ops/raycast.py):
the hit-table sampler and the grid sampler.

``build_hit_table`` is kernel K4 (csrc/hit_table.cu) on CUDA tensors and
its plain torch version ``build_hit_table_plain`` on CPU tensors.
``sample_from_hits`` / ``resolve_cells_in_hits`` are the plain pieces K1
fuses (core/render.py); they pick the hit by index where JAX contracts a
one-hot over H, which is exact for the same selection.

The grid sampler's two passes are K9a ``march_occupancy`` (the coarse
occupancy cdf per ray) and K9b ``place_samples_cdf`` (stratified quantile
placement and the fine cell lookup), csrc/grid_sampler.cu, with plain
twins ``march_occupancy_plain`` and ``place_samples_cdf_plain``; the
caller always supplies the placement jitter ``u``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.map import voxel_map as vm

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
hit_table_launches = 0          # K4
march_occupancy_launches = 0    # K9a
place_samples_cdf_launches = 0  # K9b


class RaycastConfig(NamedTuple):
    step_world: float
    n_slots: int
    n_samples: int
    voxel_size: float
    max_depth: float
    coarse_step: float = 0.0   # probe spacing; 0 -> voxel_size
    n_coarse: int = 0          # probes; 0 -> ceil(max_depth / coarse_step)
    sampler: str = "grid"
    max_hits: int = 20


def _coarse_shape(rc: RaycastConfig) -> tuple[float, int]:
    step = rc.coarse_step if rc.coarse_step > 0 else rc.voxel_size
    n = rc.n_coarse if rc.n_coarse > 0 else int(-(-rc.max_depth // step))
    return step, n


div = vm.div


def cells_of(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    return torch.floor(div(xyz, voxel_size)).to(torch.int32)


class HitTable(NamedTuple):
    aid: torch.Tensor      # (R, H) int32 active ids, -1 pad
    t_near: torch.Tensor   # (R, H) f32 entry depth (>= 0)
    seg: torch.Tensor      # (R, H) f32 in-voxel path length (0 on pads)
    cdf: torch.Tensor      # (R, H) f32 inclusive cumsum(seg)
    cell: torch.Tensor     # (R, H, 3) int32 hit voxel lattice cells
    ray_mask: torch.Tensor  # (R,) bool: any positive segment


def build_hit_table_plain(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                          rays_o: torch.Tensor, rays_d: torch.Tensor,
                          t_cap: torch.Tensor) -> HitTable:
    """Plain torch twin of K4: march S probes, keep the first probe of each
    same-voxel run, compact to <= H hits, exact slab test."""
    dev = rays_o.device
    R = rays_o.shape[0]
    H = rc.max_hits
    cstep, S = _coarse_shape(rc)
    vs = rc.voxel_size
    t_c = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) * cstep
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t_c[None, :, None]
    lid = vm.lookup_active(state, map_cfg, cells_of(pts, vs))
    occ = torch.where(t_c[None, :] <= t_cap[:, None] + cstep, lid, -1)
    prev = torch.cat([torch.full((R, 1), -2, dtype=torch.int32, device=dev), occ[:, :-1]], 1)
    new_hit = (occ >= 0) & (occ != prev)
    pos = torch.cumsum(new_hit.to(torch.int32), -1, dtype=torch.int32) - 1
    dest = torch.where(new_hit & (pos < H), pos, H).long()
    aid = torch.full((R, H + 1), -1, dtype=torch.int32, device=dev).scatter_(1, dest, occ)[:, :H]
    slot = torch.arange(S, dtype=torch.int32, device=dev).expand(R, S)
    hslot = torch.zeros((R, H + 1), dtype=torch.int32, device=dev).scatter_(1, dest, slot)[:, :H]

    ht = (hslot.to(torch.float32) + 0.5) * cstep
    hcell = torch.floor(div(rays_o[:, None, :] + rays_d[:, None, :] * ht[..., None], vs))
    vmin = hcell * vs
    vmax = vmin + vs
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-9, 1e-9, rays_d)
    t0 = (vmin - rays_o[:, None, :]) * inv_d[:, None, :]
    t1 = (vmax - rays_o[:, None, :]) * inv_d[:, None, :]
    t_near = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
    t_far = torch.minimum(torch.amin(torch.maximum(t0, t1), -1), t_cap[:, None])
    seg = torch.where(aid >= 0, torch.clamp(t_far - t_near, min=0.0), 0.0)
    cdf = torch.cumsum(seg, -1)
    return HitTable(aid, t_near, seg, cdf, hcell.to(torch.int32), cdf[:, -1] > 0.0)


def build_hit_table(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor) -> HitTable:
    """K4. Replaces nerfloam_tpu/ops/raycast.py:159-220 (build_hit_table with
    voxel_map.py:172-181 lookup_active): the XLA fusion of the (R, S) probe
    march, grid gather, run-start compaction and slab test. CPU tensors take
    the plain twin; CUDA tensors launch csrc/hit_table.cu (bound by S random
    4-byte grid reads per ray, see the source)."""
    if rays_o.device.type == "cpu":
        return build_hit_table_plain(state, map_cfg, rc, rays_o, rays_d, t_cap)
    if rays_o.device.type != "cuda":
        raise ValueError(f"build_hit_table: unsupported device {rays_o.device}")
    global hit_table_launches
    lib = kernels.lib()
    R = rays_o.shape[0]
    H = rc.max_hits
    if H > lib.nl_hit_table_max_hits():
        raise ValueError(f"max_hits {H} > kernel limit {lib.nl_hit_table_max_hits()}")
    cstep, S = _coarse_shape(rc)
    dev = rays_o.device
    grid_active = state.grid_active.contiguous()
    region_min = state.region_min.to(torch.int32).contiguous()
    o = rays_o.float().contiguous()
    d = rays_d.float().contiguous()
    tc = t_cap.float().contiguous()
    for t in (grid_active, region_min, o, d, tc):
        if t.device != dev:
            raise ValueError("build_hit_table: map and rays must share one device")
    aid = torch.empty((R, H), dtype=torch.int32, device=dev)
    t_near = torch.empty((R, H), dtype=torch.float32, device=dev)
    seg = torch.empty_like(t_near)
    cdf = torch.empty_like(t_near)
    cell = torch.empty((R, H, 3), dtype=torch.int32, device=dev)
    ray_mask = torch.empty((R,), dtype=torch.bool, device=dev)
    Dx, Dy, Dz = map_cfg.grid_dim
    err = lib.nl_hit_table(
        grid_active.data_ptr(), region_min.data_ptr(), Dx, Dy, Dz, o.data_ptr(), d.data_ptr(),
        tc.data_ptr(), R, S, H, cstep, rc.voxel_size, aid.data_ptr(), t_near.data_ptr(),
        seg.data_ptr(), cdf.data_ptr(), cell.data_ptr(), ray_mask.data_ptr(),
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "hit_table")
    hit_table_launches += 1
    return HitTable(aid, t_near, seg, cdf, cell, ray_mask)


def pack_hit_table(ht: HitTable) -> torch.Tensor:
    """(R, 7H) f32 row per ray [aid, t_near, seg, cdf, cell xyz]; aid and
    cells are exact in f32 below 2^24."""
    return torch.cat([ht.aid.float(), ht.t_near, ht.seg, ht.cdf,
                      ht.cell.float().reshape(ht.cell.shape[:-2] + (-1,))], -1)


def unpack_hit_table(packed: torch.Tensor) -> HitTable:
    H = packed.shape[-1] // 7
    cdf = packed[..., 3 * H:4 * H]
    return HitTable(
        packed[..., :H].to(torch.int32),
        packed[..., H:2 * H],
        packed[..., 2 * H:3 * H],
        cdf,
        packed[..., 4 * H:].reshape(packed.shape[:-1] + (H, 3)).to(torch.int32),
        cdf[..., -1] > 0.0,
    )


def uniform_jitter(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U(1e-4, 1 - 1e-4) placement jitter, JAX's uniform(minval, maxval)."""
    return torch.rand(shape, generator=generator, device=device) * (1.0 - 2e-4) + 1e-4


def sample_from_hits(ht: HitTable, n_samples: int, u: torch.Tensor):
    """Stratified inverse-CDF placement over the hit segments.

    ``u``: (R, M) jitter in (0, 1). Returns (z (R, M), j (R, M) hit index,
    aid (R, M), valid (R, M), ray_mask (R,)); JAX returns the one-hot of j
    where this returns j."""
    M = n_samples
    H = ht.aid.shape[1]
    dev = ht.cdf.device
    total = ht.cdf[:, -1]
    q = div(torch.arange(M, dtype=torch.float32, device=dev)[None, :] + u, float(M)) * total[:, None]
    j = torch.clamp((ht.cdf[:, None, :] < q[:, :, None]).sum(-1), 0, H - 1)
    cdf_j = torch.gather(ht.cdf, 1, j)
    seg_j = torch.gather(ht.seg, 1, j)
    tn_j = torch.gather(ht.t_near, 1, j)
    aid_j = torch.gather(ht.aid, 1, j)
    frac = torch.clamp((q - (cdf_j - seg_j)) / torch.where(seg_j > 0, seg_j, 1.0), 0.0, 1.0)
    z = tn_j + torch.clamp(frac, 1e-4, 1.0 - 1e-4) * seg_j
    valid = (total > 0)[:, None] & (aid_j >= 0) & (seg_j > 0)
    return torch.where(valid, z, 0.0), j, torch.where(valid, aid_j, -1), valid, ht.ray_mask


def resolve_cells_in_hits(ht: HitTable, cells: torch.Tensor):
    """Re-resolve sample cells (R, K, 3) against the ray's hit list by cell
    equality. Returns (first matching hit index (R, K), aid (R, K), found
    (R, K)); duplicate entries of one cell carry the same aid, so the first
    match equals JAX's one-hot average over all matches."""
    eq = torch.all(cells[:, :, None, :] == ht.cell[:, None, :, :], -1) & (ht.aid[:, None, :] >= 0)
    found = eq.any(-1)
    idx = torch.argmax(eq.to(torch.int32), -1)
    aid = torch.gather(ht.aid, 1, idx)
    return idx, torch.where(found, aid, -1), found


# ------------------------------------------------------------ grid sampler


def _grid_args(name, state: vm.MapState, *tensors):
    dev = tensors[0].device
    ins = [state.grid_active.contiguous(), state.region_min.to(torch.int32).contiguous()]
    ins += [t.float().contiguous() for t in tensors]
    if any(t.device != dev for t in ins):
        raise ValueError(f"{name}: map and rays must share one device")
    return dev, ins


def march_occupancy_plain(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                          rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor):
    """Plain torch twin of K9a: (cdf (R, S), n_occ (R,)), the running count
    of coarse slots whose midpoint is within t_cap and in an active voxel."""
    cstep, S = _coarse_shape(rc)
    t_c = (torch.arange(S, dtype=torch.float32, device=rays_o.device) + 0.5) * cstep
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t_c[None, :, None]
    lid = vm.lookup_active(state, map_cfg, cells_of(pts, rc.voxel_size))
    occ = (lid >= 0) & (t_c[None, :] <= t_cap[:, None])
    cdf = torch.cumsum(occ.to(torch.float32), -1)
    return cdf, cdf[:, -1]


def march_occupancy(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor):
    """K9a. Replaces nerfloam_tpu/ops/raycast.py:65-85 (march_occupancy,
    with voxel_map.py:172-180 lookup_active): the XLA fusion of the (R, S)
    coarse march, grid gather and per-ray cumsum. CPU tensors take the
    plain twin; CUDA tensors launch csrc/grid_sampler.cu (one warp per ray,
    bound by one 4-byte grid read per slot in range and the cdf write).
    Returns (cdf (R, S), n_occ (R,))."""
    if rays_o.device.type == "cpu":
        return march_occupancy_plain(state, map_cfg, rc, rays_o, rays_d, t_cap)
    if rays_o.device.type != "cuda":
        raise ValueError(f"march_occupancy: unsupported device {rays_o.device}")
    global march_occupancy_launches
    dev, (ga, rmin, o, d, tc) = _grid_args("march_occupancy", state, rays_o, rays_d, t_cap)
    R = o.shape[0]
    cstep, S = _coarse_shape(rc)
    cdf = torch.empty((R, S), dtype=torch.float32, device=dev)
    n_occ = torch.empty((R,), dtype=torch.float32, device=dev)
    kernels.check(kernels.lib().nl_march_occupancy(
        ga.data_ptr(), rmin.data_ptr(), *map_cfg.grid_dim, o.data_ptr(), d.data_ptr(),
        tc.data_ptr(), R, S, cstep, rc.voxel_size, cdf.data_ptr(), n_occ.data_ptr(),
        kernels.stream_ptr(dev)), "march_occupancy")
    march_occupancy_launches += 1
    return cdf, n_occ


def place_samples_cdf_plain(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                            cdf: torch.Tensor, n_occ: torch.Tensor, rays_o: torch.Tensor,
                            rays_d: torch.Tensor, t_cap: torch.Tensor, u: torch.Tensor):
    """Plain torch twin of K9b: (z (R, M), aid (R, M), valid (R, M),
    ray_mask (R,)); z = 0 and aid = -1 where not valid."""
    S = cdf.shape[1]
    M = u.shape[1]
    cstep, _ = _coarse_shape(rc)
    ray_mask = n_occ > 0
    m = torch.arange(M, dtype=torch.float32, device=cdf.device)
    q = div(m[None, :] + u, float(M)) * n_occ[:, None]
    j = torch.clamp((cdf[:, None, :] < q[:, :, None]).sum(-1), 0, S - 1)
    frac = torch.clamp(q - (torch.gather(cdf, 1, j) - 1.0), 0.0, 1.0)
    z = (j.to(torch.float32) + frac) * cstep
    fpts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    aid = vm.lookup_active(state, map_cfg, cells_of(fpts, rc.voxel_size))
    valid = ray_mask[:, None] & (aid >= 0) & (z <= t_cap[:, None])
    return torch.where(valid, z, 0.0), torch.where(valid, aid, -1), valid, ray_mask


def place_samples_cdf(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                      cdf: torch.Tensor, n_occ: torch.Tensor, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, t_cap: torch.Tensor, u: torch.Tensor):
    """K9b. Replaces nerfloam_tpu/ops/raycast.py:88-130 (place_samples_cdf):
    the XLA fusion of the stratified quantile, the (R, M, S) compare-count
    against the cdf, the depth and the fine grid lookup. ``u`` (R, M) is
    the jitter. CPU tensors take the plain twin; CUDA tensors launch
    csrc/grid_sampler.cu (one thread per sample, a binary search over the
    ray's cdf row). Returns (z, aid, valid, ray_mask)."""
    if rays_o.device.type == "cpu":
        return place_samples_cdf_plain(state, map_cfg, rc, cdf, n_occ, rays_o, rays_d, t_cap, u)
    if rays_o.device.type != "cuda":
        raise ValueError(f"place_samples_cdf: unsupported device {rays_o.device}")
    global place_samples_cdf_launches
    dev, (ga, rmin, cd, no, o, d, tc, uu) = _grid_args("place_samples_cdf", state, cdf, n_occ,
                                                       rays_o, rays_d, t_cap, u)
    R, S = cd.shape
    M = uu.shape[1]
    cstep, _ = _coarse_shape(rc)
    z = torch.empty((R, M), dtype=torch.float32, device=dev)
    aid = torch.empty((R, M), dtype=torch.int32, device=dev)
    valid = torch.empty((R, M), dtype=torch.bool, device=dev)
    ray_mask = torch.empty((R,), dtype=torch.bool, device=dev)
    kernels.check(kernels.lib().nl_place_samples_cdf(
        ga.data_ptr(), rmin.data_ptr(), *map_cfg.grid_dim, cd.data_ptr(), no.data_ptr(),
        o.data_ptr(), d.data_ptr(), tc.data_ptr(), uu.data_ptr(), R, S, M, cstep, rc.voxel_size,
        z.data_ptr(), aid.data_ptr(), valid.data_ptr(), ray_mask.data_ptr(),
        kernels.stream_ptr(dev)), "place_samples_cdf")
    place_samples_cdf_launches += 1
    return z, aid, valid, ray_mask


def sample_rays_cdf(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor,
                    u: torch.Tensor):
    """Inverse-CDF sampling over the occupied voxels along each ray: K9a
    then K9b (nerfloam_tpu/ops/raycast.py:346-381)."""
    cdf, n_occ = march_occupancy(state, map_cfg, rc, rays_o, rays_d, t_cap)
    return place_samples_cdf(state, map_cfg, rc, cdf, n_occ, rays_o, rays_d, t_cap, u)
