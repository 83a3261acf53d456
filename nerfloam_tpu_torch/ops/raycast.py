"""Ray sampling against the voxel map (port of nerfloam_tpu/ops/raycast.py):
the hit-table sampler and the grid sampler.

``build_hit_table`` is kernel K4 (csrc/hit_table.cu) on CUDA tensors and
its plain torch version ``build_hit_table_plain`` on CPU tensors;
``build_hit_table_packed`` is its form for BA, the table packed into one
f32 row per ray by the same launch (``pack_hit_table`` of the table).
``sample_from_hits`` / ``resolve_cells_in_hits`` are the plain pieces K1
fuses (core/render.py); they pick the hit by index where JAX contracts a
one-hot over H, which is exact for the same selection.

The grid sampler's two passes are K9a ``march_occupancy`` (the coarse
occupancy cdf per ray) and K9b ``place_samples_cdf`` (stratified quantile
placement and the fine cell lookup), csrc/grid_sampler.cu, with plain
twins ``march_occupancy_plain`` and ``place_samples_cdf_plain``; the
caller always supplies the placement jitter ``u``. A tracker places
samples over one frame's cdf in every iteration, and BA over one step's
superset cdf, so each makes a ``CdfPlacer`` once and calls it per
iteration: ``CdfPlacer.march`` checks the map and packs K9b's fixed
arguments once, allocates the cdf and the outputs, and launches K9a into
them (``march_occupancy`` is one such march, for a caller that wants the
cdf alone).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.map import voxel_map as vm

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
hit_table_launches = 0          # K4
march_occupancy_launches = 0    # K9a
place_samples_cdf_launches = 0  # K9b
_HT = "build_hit_table"
_PLACE = "place_samples_cdf"
_MARCH = "march_occupancy"
_F32 = torch.float32
_ORIGIN_STRIDES = ((0, 1), (3, 1))  # rays_o of K9b and K8: one shared origin, or one per ray


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


div, rdiv = vm.div, vm.rdiv


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
    # contiguous tables, as K4 writes them and K1 reads them
    return HitTable(aid.contiguous(), t_near, seg, cdf, hcell.to(torch.int32), cdf[:, -1] > 0.0)


def _hit_table_launch(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                      rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor,
                      packed: bool):
    """One launch of csrc/hit_table.cu on CUDA tensors taken as they are
    (see build_hit_table): the six tables, or BA's packed rows."""
    global hit_table_launches
    dev = rays_d.device
    R, H = rays_d.shape[0], rc.max_hits
    lib = kernels.lib()
    if not 1 <= H <= lib.nl_hit_table_max_hits():
        raise ValueError(f"{_HT}: max_hits {H} outside [1, {lib.nl_hit_table_max_hits()}], the "
                         "hits a warp holds in shared memory")
    kernels.expect(_HT, dev, torch.int32, grid_active=state.grid_active,
                   region_min=state.region_min)
    kernels.expect(_HT, dev, _F32, rays_d=rays_d, t_cap=t_cap)
    kernels.expect_shape(_HT, grid_active=(state.grid_active, (int(np.prod(map_cfg.grid_dim)),)),
                         region_min=(state.region_min, (3,)), rays_d=(rays_d, (R, 3)),
                         t_cap=(t_cap, (R,)))
    o_stride = kernels.expect_origin(_HT, dev, rays_o, R)
    cstep, S = _coarse_shape(rc)
    if packed:
        out = (torch.empty((R, 7 * H), dtype=_F32, device=dev),)
        ptrs = (None,) * 6 + (out[0].data_ptr(),)
    else:
        out = (torch.empty((R, H), dtype=torch.int32, device=dev),
               torch.empty((R, H), dtype=_F32, device=dev),
               torch.empty((R, H), dtype=_F32, device=dev),
               torch.empty((R, H), dtype=_F32, device=dev),
               torch.empty((R, H, 3), dtype=torch.int32, device=dev),
               torch.empty((R,), dtype=torch.bool, device=dev))
        ptrs = tuple(t.data_ptr() for t in out) + (None,)
    err = lib.nl_hit_table(
        state.grid_active.data_ptr(), state.region_min.data_ptr(), *map_cfg.grid_dim,
        rays_o.data_ptr(), o_stride, rays_d.data_ptr(), t_cap.data_ptr(), R, S, H, cstep,
        rc.voxel_size, *ptrs, kernels.stream_ptr(dev))
    kernels.check(err, _HT)
    hit_table_launches += 1
    return out


def _device_type(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def build_hit_table(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor) -> HitTable:
    """K4. Replaces nerfloam_tpu/ops/raycast.py:159-220 (build_hit_table with
    voxel_map.py:172-181 lookup_active): the XLA fusion of the (R, S) probe
    march, grid gather, run-start compaction and slab test. CPU tensors take
    the plain twin; CUDA tensors launch csrc/hit_table.cu once (a warp per
    ray, see the source), on inputs as the kernel reads them: rays_d (R, 3)
    and t_cap (R,) contiguous f32, rays_o (R, 3) f32 rows with a row stride
    of 3, or of 0 for one origin expanded to every ray (the tracker's
    form), the map's grid_active and region_min contiguous int32. Nothing
    is converted or copied: anything else raises ValueError."""
    if _device_type(_HT, rays_o) == "cpu":
        return build_hit_table_plain(state, map_cfg, rc, rays_o, rays_d, t_cap)
    return HitTable(*_hit_table_launch(state, map_cfg, rc, rays_o, rays_d, t_cap, False))


def build_hit_table_packed(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                           rays_o: torch.Tensor, rays_d: torch.Tensor,
                           t_cap: torch.Tensor) -> torch.Tensor:
    """K4 in BA's form: ``pack_hit_table(build_hit_table(...))``, the (R,
    7H) f32 rows [aid, t_near, seg, cdf, cell xyz], written by the one
    launch (inputs as build_hit_table takes them). CPU tensors pack the
    plain twin's table."""
    if _device_type(_HT, rays_o) == "cpu":
        return pack_hit_table(build_hit_table_plain(state, map_cfg, rc, rays_o, rays_d, t_cap))
    return _hit_table_launch(state, map_cfg, rc, rays_o, rays_d, t_cap, True)[0]


def pack_hit_table(ht: HitTable) -> torch.Tensor:
    """(R, 7H) f32 row per ray [aid, t_near, seg, cdf, cell xyz]; aid and
    cells are exact in f32 below 2^24."""
    return torch.cat([ht.aid.float(), ht.t_near, ht.seg, ht.cdf,
                      ht.cell.float().reshape(ht.cell.shape[:-2] + (-1,))], -1)


def unpack_hit_table(packed: torch.Tensor) -> HitTable:
    """pack_hit_table's inverse: t_near, seg and cdf are views of
    ``packed`` (rows of H, row stride 7H, as K1 takes them); aid and the
    cells are cast into contiguous int32 tables."""
    H = packed.shape[-1] // 7
    cdf = packed[..., 3 * H:4 * H]
    to_int = dict(dtype=torch.int32, memory_format=torch.contiguous_format)
    return HitTable(
        packed[..., :H].to(**to_int),
        packed[..., H:2 * H],
        packed[..., 2 * H:3 * H],
        cdf,
        packed[..., 4 * H:].reshape(packed.shape[:-1] + (H, 3)).to(**to_int),
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
    return cdf, cdf[:, -1].contiguous()  # its own row, as the kernel writes it


def march_occupancy(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor):
    """K9a. Replaces nerfloam_tpu/ops/raycast.py:65-85 (march_occupancy,
    with voxel_map.py:172-180 lookup_active): the XLA fusion of the (R, S)
    coarse march, grid gather and per-ray cumsum. One march of a fresh
    placer (``CdfPlacer.march``, which checks the inputs as it takes them
    and raises on what it would have to convert); CPU tensors take the
    plain twin. Returns (cdf (R, S), n_occ (R,))."""
    placer = CdfPlacer.march(state, map_cfg, rc, rays_o, rays_d, t_cap, 0)
    return placer.cdf, placer.n_occ


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


class _PlaceArgs(ctypes.Structure):
    """K9b's (and K9a's) arguments fixed over a loop: ``PlaceArgs`` of
    csrc/grid_sampler.cu, the same fields in the same order (checked
    against the library's ``nl_place_args_layout`` before the first
    launch)."""

    _fields_ = [("grid_active", ctypes.c_void_p), ("rmin", ctypes.c_void_p),
                ("Dx", ctypes.c_int), ("Dy", ctypes.c_int), ("Dz", ctypes.c_int),
                ("cdf", ctypes.c_void_p), ("n_occ", ctypes.c_void_p), ("t_cap", ctypes.c_void_p),
                ("C", ctypes.c_int), ("R", ctypes.c_int), ("S", ctypes.c_int),
                ("M", ctypes.c_int), ("cstep", ctypes.c_float), ("vs", ctypes.c_float),
                ("z", ctypes.c_void_p), ("aid", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("ray_mask", ctypes.c_void_p)]


_place_layout_checked = False


def _check_place_layout(lib) -> None:
    """Raise unless _PlaceArgs has the size and field offsets of the
    library's PlaceArgs (once per process)."""
    global _place_layout_checked
    if _place_layout_checked:
        return
    out = (ctypes.c_int * 32)()
    got = list(out[:lib.nl_place_args_layout(out)])
    want = [ctypes.sizeof(_PlaceArgs)] + [getattr(_PlaceArgs, f).offset
                                          for f, _ in _PlaceArgs._fields_]
    if got != want:
        raise RuntimeError(f"{_PLACE}: _PlaceArgs (size, offsets) {want} differ from "
                           f"csrc/grid_sampler.cu's PlaceArgs {got}")
    _place_layout_checked = True


class CdfPlacer:
    """K9b prepared for a loop over one cdf: the map, K9a's cdf and n_occ
    (C rows), t_cap (C,) and the sample count M are checked once, the
    outputs for R rays (``n_rays``, C unless given) allocated once, and
    each call ``placer(rays_o, rays_d, u, rows=None)`` checks only the
    rays, the jitter and ``rows``, and on the card makes one ctypes call of
    seven arguments. A tracker makes one per frame and calls it once per
    iteration; BA makes one per step over its ray superset and gives each
    iteration's rays their cdf rows, ``rows`` (R,) int32 in [0, C) (on the
    card a row outside that range reads nothing and its ray misses).
    Without ``rows`` ray r takes row r, which needs R = C. Every input must
    already be what the kernel reads (f32 or int32, contiguous, on t_cap's
    device; ``rays_o`` may be one origin expanded to (R, 3)): nothing is
    converted or copied, and a tensor that would need it raises ValueError.

    ``CdfPlacer.march(...)`` makes one over a march of its own (K9a): the
    trackers and BA make theirs so, and ``cdf`` / ``n_occ`` are the
    placer's. ``CdfPlacer(..., cdf, n_occ, ...)`` takes a given cdf.

    On the card a call returns the placer's own (z, aid, valid, ray_mask)
    buffers, overwritten by the next call: the trackers and BA consume them
    within the iteration. CPU tensors take ``place_samples_cdf_plain``."""

    def __init__(self, state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                 cdf: torch.Tensor, n_occ: torch.Tensor, t_cap: torch.Tensor, n_samples: int,
                 n_rays: int | None = None):
        _device_type(_PLACE, t_cap)
        dev, C = t_cap.device, cdf.shape[0]
        kernels.expect(_PLACE, dev, _F32, cdf=cdf, n_occ=n_occ)
        kernels.expect_shape(_PLACE, n_occ=(n_occ, (C,)))
        self._check_map(_PLACE, dev, state, map_cfg, t_cap, C)
        self._setup(state, map_cfg, rc, cdf, n_occ, t_cap, n_samples, n_rays)

    @classmethod
    def march(cls, state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
              rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor, n_samples: int,
              n_rays: int | None = None) -> "CdfPlacer":
        """K9a, launched as part of making the placer: the C rays (rays_d
        (C, 3) and t_cap (C,) contiguous f32; rays_o (C, 3) f32 rows with
        a row stride of 3, or of 0 for one origin expanded to every ray, as
        the trackers pass it) are marched into the placer's own cdf (C, S)
        and n_occ (C,), allocated here and never filled, by one launch of
        csrc/grid_sampler.cu that reads its fixed arguments from the
        PlaceArgs K9b uses. The map and t_cap are checked once; nothing is
        converted or copied: anything else raises ValueError. CPU tensors
        take ``march_occupancy_plain``. Then the placer is ready for K9b's
        calls (``n_samples`` M, ``n_rays`` R as in the constructor)."""
        _device_type(_MARCH, t_cap)
        dev, C = t_cap.device, rays_d.shape[0]
        kernels.expect(_MARCH, dev, _F32, rays_d=rays_d)
        kernels.expect_shape(_MARCH, rays_d=(rays_d, (C, 3)))
        o_stride = kernels.expect_origin(_MARCH, dev, rays_o, C)
        self = cls.__new__(cls)
        self._check_map(_MARCH, dev, state, map_cfg, t_cap, C)
        if dev.type == "cpu":
            cdf, n_occ = march_occupancy_plain(state, map_cfg, rc, rays_o, rays_d, t_cap)
        else:
            cdf = torch.empty((C, _coarse_shape(rc)[1]), dtype=_F32, device=dev)
            n_occ = torch.empty((C,), dtype=_F32, device=dev)
        self._setup(state, map_cfg, rc, cdf, n_occ, t_cap, n_samples, n_rays)
        if self._out is not None:
            global march_occupancy_launches
            err = self._lib.nl_march_occupancy(self._args_ptr, rays_o.data_ptr(), o_stride,
                                               rays_d.data_ptr(), kernels.raw_stream(self._index))
            if err:
                kernels.check(err, _MARCH)
            march_occupancy_launches += 1
        return self

    @staticmethod
    def _check_map(name, dev, state, map_cfg, t_cap, C):
        kernels.expect(name, dev, torch.int32, grid_active=state.grid_active,
                       region_min=state.region_min)
        kernels.expect(name, dev, _F32, t_cap=t_cap)
        kernels.expect_shape(name, grid_active=(state.grid_active, (math.prod(map_cfg.grid_dim),)),
                             region_min=(state.region_min, (3,)), t_cap=(t_cap, (C,)))

    def _setup(self, state, map_cfg, rc, cdf, n_occ, t_cap, n_samples, n_rays):
        """Over checked inputs: the outputs allocated and K9b's (and K9a's)
        fixed arguments packed."""
        dev = t_cap.device
        C, S = cdf.shape
        R = C if n_rays is None else n_rays
        M = n_samples
        self.device, self.C, self.R, self.M = dev, C, R, M
        self.cdf, self.n_occ = cdf, n_occ
        self._rd_shape, self._u_shape, self._u_stride, self._rows_shape = (R, 3), (R, M), (M, 1), (R,)
        self._inputs = (state, map_cfg, rc, cdf, n_occ, t_cap)  # holds what _args points at
        self._out = None
        self._index = -2  # matches no tensor's get_device(): CPU calls take the full checks
        if dev.type == "cpu":
            return
        self._index = t_cap.get_device()
        lib = self._lib = kernels.lib()
        _check_place_layout(lib)
        if M > 0 and S > lib.nl_place_max_slots():
            raise ValueError(f"{_PLACE}: {S} coarse slots > {lib.nl_place_max_slots()}, the cdf "
                             "rows the kernel holds in shared memory")
        # four allocations, not one buffer cut into views, which costs the
        # host as much (chip_smoke.py's K9b host readings)
        self._out = (torch.empty((R, M), dtype=torch.float32, device=dev),
                     torch.empty((R, M), dtype=torch.int32, device=dev),
                     torch.empty((R, M), dtype=torch.bool, device=dev),
                     torch.empty((R,), dtype=torch.bool, device=dev))
        cstep, _ = _coarse_shape(rc)
        gx, gy, gz = map_cfg.grid_dim
        z, aid, valid, ray_mask = (t.data_ptr() for t in self._out)
        self._args = _PlaceArgs(
            grid_active=state.grid_active.data_ptr(), rmin=state.region_min.data_ptr(), Dx=gx,
            Dy=gy, Dz=gz, cdf=cdf.data_ptr(), n_occ=n_occ.data_ptr(), t_cap=t_cap.data_ptr(),
            C=C, R=R, S=S, M=M, cstep=cstep, vs=rc.voxel_size, z=z, aid=aid, valid=valid,
            ray_mask=ray_mask)
        self._args_ptr = ctypes.addressof(self._args)
        self._launch = lib.nl_place_samples_cdf

    def __call__(self, rays_o: torch.Tensor, rays_d: torch.Tensor, u: torch.Tensor,
                 rows: torch.Tensor | None = None):
        index = self._index
        # the usual cases on the card in one expression (each term a
        # fraction of a us); anything else, and every CPU call, goes through
        # the full checks, which raise
        if not (rays_d.dtype is _F32 and u.dtype is _F32 and rays_o.dtype is _F32
                and rays_d.shape == self._rd_shape and rays_o.shape == self._rd_shape
                and u.shape == self._u_shape and rays_d.stride() == (3, 1)
                and u.stride() == self._u_stride and (o_st := rays_o.stride()) in _ORIGIN_STRIDES
                and rays_d.get_device() == index and u.get_device() == index
                and rays_o.get_device() == index
                and (self.R == self.C if rows is None else
                     rows.dtype is torch.int32 and rows.shape == self._rows_shape
                     and rows.stride() == (1,) and rows.get_device() == index)):
            self._check(rays_o, rays_d, u, rows)
            o_st = rays_o.stride()
        if self._out is None:
            state, map_cfg, rc, cdf, n_occ, t_cap = self._inputs
            if rows is not None:
                cdf, n_occ, t_cap = (t[rows.long()] for t in (cdf, n_occ, t_cap))
            return place_samples_cdf_plain(state, map_cfg, rc, cdf, n_occ, rays_o, rays_d, t_cap,
                                           u)
        global place_samples_cdf_launches
        err = self._launch(self._args_ptr, None if rows is None else rows.data_ptr(),
                           rays_o.data_ptr(), o_st[0], rays_d.data_ptr(), u.data_ptr(),
                           kernels.raw_stream(index))
        if err:
            kernels.check(err, _PLACE)
        place_samples_cdf_launches += 1
        return self._out

    def _check(self, rays_o, rays_d, u, rows):
        dev, R = self.device, self.R
        kernels.expect(_PLACE, dev, _F32, rays_d=rays_d, u=u)
        kernels.expect_shape(_PLACE, rays_d=(rays_d, (R, 3)), u=(u, (R, self.M)))
        if rows is not None:
            kernels.expect(_PLACE, dev, torch.int32, rows=rows)
            kernels.expect_shape(_PLACE, rows=(rows, (R,)))
        elif R != self.C:
            raise ValueError(f"{_PLACE}: {R} rays over {self.C} cdf rows need rows")
        kernels.expect_origin(_PLACE, dev, rays_o, R)


def place_samples_cdf(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                      cdf: torch.Tensor, n_occ: torch.Tensor, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, t_cap: torch.Tensor, u: torch.Tensor):
    """K9b. Replaces nerfloam_tpu/ops/raycast.py:88-130 (place_samples_cdf):
    the XLA fusion of the stratified quantile, the (R, M, S) compare-count
    against the cdf, the depth and the fine grid lookup. ``u`` (R, M) is
    the jitter. One call of a CdfPlacer made for it (see there: inputs are
    checked, never converted); CUDA tensors launch csrc/grid_sampler.cu,
    one warp per ray with its cdf row in shared memory. Returns (z, aid,
    valid, ray_mask)."""
    _device_type(_PLACE, rays_o)
    return CdfPlacer(state, map_cfg, rc, cdf, n_occ, t_cap, u.shape[-1])(rays_o, rays_d, u)


def sample_rays_cdf(state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig,
                    rays_o: torch.Tensor, rays_d: torch.Tensor, t_cap: torch.Tensor,
                    u: torch.Tensor):
    """Inverse-CDF sampling over the occupied voxels along each ray: K9a
    then K9b (nerfloam_tpu/ops/raycast.py:346-381)."""
    cdf, n_occ = march_occupancy(state, map_cfg, rc, rays_o, rays_d, t_cap)
    return place_samples_cdf(state, map_cfg, rc, cdf, n_occ, rays_o, rays_d, t_cap, u)
