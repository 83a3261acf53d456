"""Device-resident sparse voxel map (port of nerfloam_tpu/map/voxel_map.py).

One row per lattice point (= octree corner octant); ``is_surface`` marks
directly observed voxels and ``corner_idx`` holds each surface voxel's 8
corner rows. Spatial lookup goes through a dense region-local grid rebuilt
around the sensor. Every function keeps the JAX version's static shapes,
so a frame never waits on the host: out-of-range writes that JAX drops
(``mode="drop"``) go to one trash row appended to the target and sliced
off (``_set_drop`` / ``_add_drop``).

Functions return a new ``MapState`` rather than editing their input, like
the JAX code: the pipeline keeps no rewind point, but tests compare the
before and after states.

``insert_points`` is kernel K7 (csrc/insert.cu) on CUDA tensors and its
plain torch twin ``insert_points_plain`` on CPU tensors. The other
map-maintenance fusions are plain torch and wait for later kernels: K5
(``reconcile_packed``, ``bump_upd_count``, ``pack_embeddings``) and K6
(``recenter``, ``refresh_active``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.interp import CORNER_OFFSETS

# K7 launches on CUDA tensors (plain integer; chip_smoke.py resets and reads it)
insert_launches = 0
_INT_MAX = 2**31 - 1


class MapConfig(NamedTuple):
    """Static map parameters."""

    capacity: int
    grid_dim: tuple
    voxel_size: float
    feat_dim: int = 16
    emb_dtype: str = "float32"  # "float32" | "bfloat16"
    active_cap: int = 0         # 0 -> capacity
    support_dist: float = 0.0   # > 0: insert_frame also allocates a support
    #   voxel this far past each measured point (JAX MapConfig.support_dist)
    support_sym: bool = False   # and its mirror on the sensor side


class MapState(NamedTuple):
    lat_coords: torch.Tensor    # (C, 3) int32 lattice coords per row
    is_surface: torch.Tensor    # (C,) bool
    corner_idx: torch.Tensor    # (C, 8) int32 corner rows (surface rows)
    embeddings: torch.Tensor    # (C, F) emb_dtype
    num_lat: torch.Tensor       # () int32 allocated rows
    grid: torch.Tensor          # (Dx*Dy*Dz,) int32 cell -> row | -1
    region_min: torch.Tensor    # (3,) int32 lattice coord of grid cell (0,0,0)
    active_ids: torch.Tensor    # (A,) int32 rows of the active surface voxels
    n_active: torch.Tensor      # () int32
    grid_active: torch.Tensor   # (Dx*Dy*Dz,) int32 cell -> active index | -1
    packed: torch.Tensor        # (A, 8F) float32 corner features per voxel
    active_coords: torch.Tensor  # (A, 3) int32
    num_cand: torch.Tensor      # () int32 new-voxel candidates of the last insert
    upd_count: torch.Tensor     # (C,) int32 BA steps that touched each voxel


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def acap(cfg: MapConfig) -> int:
    return cfg.active_cap if cfg.active_cap > 0 else cfg.capacity


def create(cfg: MapConfig, device="cuda") -> MapState:
    C, A = cfg.capacity, acap(cfg)
    total = int(np.prod(cfg.grid_dim))
    i32 = dict(dtype=torch.int32, device=device)
    return MapState(
        lat_coords=torch.zeros((C, 3), **i32),
        is_surface=torch.zeros((C,), dtype=torch.bool, device=device),
        corner_idx=torch.full((C, 8), -1, **i32),
        embeddings=torch.zeros((C, cfg.feat_dim), dtype=_DTYPES[cfg.emb_dtype], device=device),
        num_lat=torch.zeros((), **i32),
        grid=torch.full((total,), -1, **i32),
        region_min=torch.zeros((3,), **i32),
        active_ids=torch.zeros((A,), **i32),
        n_active=torch.zeros((), **i32),
        grid_active=torch.full((total,), -1, **i32),
        packed=torch.zeros((A, 8 * cfg.feat_dim), dtype=torch.float32, device=device),
        active_coords=torch.zeros((A, 3), **i32),
        num_cand=torch.zeros((), **i32),
        upd_count=torch.zeros((C,), **i32),
    )


def _set_drop(target: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``target.at[idx].set(values, mode="drop")`` for idx in [0, len(target)]:
    index len(target) lands in a trash row that is sliced off."""
    buf = torch.cat([target, target[:1]])
    buf[idx.long()] = values if torch.is_tensor(values) else torch.as_tensor(
        values, dtype=target.dtype, device=target.device)
    return buf[:-1]


def _add_drop(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``target.at[idx].add(values, mode="drop")``, trash row as in _set_drop."""
    buf = torch.cat([target, torch.zeros_like(target[:1])])
    buf.index_add_(0, idx.long(), values.to(target.dtype))
    return buf[:-1]


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as IEEE division. torch on CUDA turns division by a
    Python scalar into a multiply by its reciprocal, which can move
    floor(x / voxel_size) across a voxel face; a same-device 0-d tensor
    divisor keeps the true division the kernels use (__fdiv_rn)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _flat_cell(rel: torch.Tensor, grid_dim: tuple):
    """(..., 3) region-relative cells -> flat index + in-bounds mask."""
    Dx, Dy, Dz = grid_dim
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    inb = (x >= 0) & (x < Dx) & (y >= 0) & (y < Dy) & (z >= 0) & (z < Dz)
    return (x * Dy + y) * Dz + z, inb


def _grid_read(grid: torch.Tensor, region_min: torch.Tensor, cfg: MapConfig,
               coords: torch.Tensor) -> torch.Tensor:
    flat, inb = _flat_cell(coords - region_min, cfg.grid_dim)
    val = grid[torch.clamp(flat, 0, grid.shape[0] - 1).long()]
    return torch.where(inb, val, -1)


def lookup(state: MapState, cfg: MapConfig, coords: torch.Tensor) -> torch.Tensor:
    """Lattice rows for integer lattice coords (..., 3); -1 if absent/outside."""
    return _grid_read(state.grid, state.region_min, cfg, coords)


def lookup_active(state: MapState, cfg: MapConfig, coords: torch.Tensor) -> torch.Tensor:
    """Active-set indices for lattice coords (..., 3); -1 where the cell holds
    no active surface voxel."""
    return _grid_read(state.grid_active, state.region_min, cfg, coords)


def recenter(state: MapState, cfg: MapConfig, center_world: torch.Tensor) -> MapState:
    """Rebuild the dense grid around a new world-space center (one scatter
    over the lattice table)."""
    dev = state.grid.device
    dims = torch.tensor(cfg.grid_dim, dtype=torch.int32, device=dev)
    region_min = torch.floor(center_world / cfg.voxel_size).to(torch.int32) - dims // 2
    total = int(np.prod(cfg.grid_dim))
    ids = torch.arange(cfg.capacity, dtype=torch.int32, device=dev)
    flat, inb = _flat_cell(state.lat_coords - region_min, cfg.grid_dim)
    ok = inb & (ids < state.num_lat)
    grid = _set_drop(torch.full((total,), -1, dtype=torch.int32, device=dev),
                     torch.where(ok, flat, total), ids)
    return state._replace(grid=grid, region_min=region_min)


def refresh_active(state: MapState, cfg: MapConfig) -> MapState:
    """Rebuild the active surface set, grid_active and the packed (A, 8F)
    corner table from the in-region surface voxels."""
    dev = state.grid.device
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    total = int(np.prod(cfg.grid_dim))
    ids = torch.arange(C, dtype=torch.int32, device=dev)
    flat, inb = _flat_cell(state.lat_coords - state.region_min, cfg.grid_dim)
    act = inb & state.is_surface & (ids < state.num_lat)
    rank = torch.cumsum(act.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = act & (rank < A)
    active_ids = _set_drop(torch.zeros((A,), dtype=torch.int32, device=dev),
                           torch.where(keep, rank, A), ids)
    n_active = act.sum(dtype=torch.int32)
    grid_active = _set_drop(torch.full((total,), -1, dtype=torch.int32, device=dev),
                            torch.where(keep, flat, total), rank)
    return state._replace(
        active_ids=active_ids,
        n_active=n_active,
        grid_active=grid_active,
        packed=_pack(state.embeddings, state.corner_idx[active_ids.long()], A, F),
        active_coords=state.lat_coords[active_ids.long()],
    )


def _pack(embeddings: torch.Tensor, cidx: torch.Tensor, n: int, F: int) -> torch.Tensor:
    return embeddings[torch.clamp(cidx, min=0).long()].float().reshape(n, 8 * F)


def reconcile_packed(state: MapState, cfg: MapConfig, new_packed: torch.Tensor,
                     touched: torch.Tensor, touched_cap: int) -> torch.Tensor:
    """Fold the optimized packed-copy deltas of the touched voxels back into
    the canonical (C, F) embeddings; a corner shared by k touched voxels
    gets the mean of its k deltas. Returns the new embeddings."""
    dev = new_packed.device
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    T = touched_cap
    rank = torch.cumsum(touched.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = touched & (rank < T)
    dest = torch.where(keep, rank, T)
    rows = torch.arange(A, dtype=torch.int32, device=dev)
    t_rows = _set_drop(torch.zeros((T,), dtype=torch.int32, device=dev), dest, rows).long()
    t_valid = _set_drop(torch.zeros((T,), dtype=torch.bool, device=dev), dest, keep)
    delta = (new_packed[t_rows] - state.packed[t_rows]).reshape(T * 8, F)
    cids = state.corner_idx[state.active_ids[t_rows].long()]
    cflat = torch.where(t_valid[:, None], cids, C).reshape(-1)
    mult = _add_drop(torch.zeros((C,), dtype=torch.float32, device=dev), cflat,
                     torch.ones_like(cflat, dtype=torch.float32))
    delta = delta / torch.clamp(mult[torch.clamp(cflat, 0, C - 1).long()], min=1.0)[:, None]
    # cast the f32 deltas to the embedding type BEFORE adding, as JAX does
    return _add_drop(state.embeddings, cflat, delta.to(state.embeddings.dtype))


def bump_upd_count(state: MapState, cfg: MapConfig, touched: torch.Tensor) -> torch.Tensor:
    """(C,) upd_count + 1 at every active voxel row touched this BA step."""
    dest = torch.where(touched, state.active_ids, cfg.capacity)
    return _add_drop(state.upd_count, dest, torch.ones_like(dest))


def pack_embeddings(state: MapState, cfg: MapConfig) -> torch.Tensor:
    """(A, 8F) packed corner features from the current embeddings."""
    A = acap(cfg)
    return _pack(state.embeddings, state.corner_idx[state.active_ids.long()], A, cfg.feat_dim)


def insert_points_plain(state: MapState, cfg: MapConfig, points_world: torch.Tensor,
                        valid: torch.Tensor, cand_cap: int = 0,
                        append_active: bool = False) -> MapState:
    """Plain torch twin of K7: allocate voxels (and their corner lattice
    points) at observed points. Each observed voxel becomes surface, its 8
    corners are allocated if absent. Duplicates are resolved by electing
    the smallest point (corner) slot per grid cell (JAX lets any duplicate
    win, so its row ids differ but its sets are the same). Candidates are
    compacted to ``cand_cap`` rows (all P when 0 or >= P) before the corner
    pass. Out-of-region points are dropped; rows past capacity are dropped
    and their voxels stay inactive while ``num_lat`` still counts them, so
    the host can grow the map."""
    dev = points_world.device
    P = points_world.shape[0]
    C = cfg.capacity
    total = int(np.prod(cfg.grid_dim))
    i32 = dict(dtype=torch.int32, device=dev)
    Pc = cand_cap if 0 < cand_cap < P else P

    vox = torch.floor(div(points_world, cfg.voxel_size)).to(torch.int32)
    vflat, vox_inb = _flat_cell(vox - state.region_min, cfg.grid_dim)
    ok = valid & vox_inb
    slot = torch.arange(P, **i32)
    vdest = torch.where(ok, vflat, total).long()
    winner = torch.full((total + 1,), _INT_MAX, **i32).scatter_reduce_(0, vdest, slot, "amin")
    first = ok & (winner[vdest] == slot)

    lid0 = state.grid[torch.clamp(vflat, 0, total - 1).long()]
    already_surface = (lid0 >= 0) & state.is_surface[torch.clamp(lid0, min=0).long()]
    cand = first & ~already_surface
    num_cand = cand.sum(dtype=torch.int32)

    crank = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = cand & (crank < Pc)
    cdest = torch.where(keep, crank, Pc)
    vox_c = _set_drop(torch.zeros((Pc, 3), **i32), cdest, vox)
    cand_c = _set_drop(torch.zeros((Pc,), dtype=torch.bool, device=dev), cdest, keep)

    offsets = torch.as_tensor(CORNER_OFFSETS, device=dev)
    corners = vox_c[:, None, :] + offsets[None]
    cflat3 = corners.reshape(-1, 3)
    c_flatidx, c_inb = _flat_cell(cflat3 - state.region_min, cfg.grid_dim)
    c_lid = lookup(state, cfg, cflat3)
    c_ok = torch.repeat_interleave(cand_c, 8) & c_inb & (c_lid < 0)
    cslot = torch.arange(8 * Pc, **i32)
    c_dest = torch.where(c_ok, c_flatidx, total).long()
    cwinner = torch.full((total + 1,), _INT_MAX, **i32).scatter_reduce_(0, c_dest, cslot, "amin")
    cnew = c_ok & (cwinner[c_dest] == cslot)

    ranks = torch.cumsum(cnew.to(torch.int32), 0, dtype=torch.int32) - 1
    new_ids = state.num_lat + ranks
    fits = new_ids < C
    lat_coords = _set_drop(state.lat_coords, torch.where(cnew & fits, new_ids, C), cflat3)
    grid = _set_drop(state.grid, torch.where(cnew & fits, c_flatidx, total), new_ids)
    num_lat = state.num_lat + cnew.sum(dtype=torch.int32)
    state = state._replace(lat_coords=lat_coords, grid=grid, num_lat=num_lat)

    c_lid2 = lookup(state, cfg, corners)
    complete = torch.all(c_lid2 >= 0, dim=-1)
    vox_id = c_lid2[:, 0]
    act = cand_c & complete
    dest = torch.where(act, vox_id, C)
    state = state._replace(
        is_surface=_set_drop(state.is_surface, dest, True),
        corner_idx=_set_drop(state.corner_idx, dest, c_lid2),
        num_cand=num_cand,
    )
    if not append_active:
        return state

    # append the newly activated voxels to the active set (lazy recentering)
    A, F = acap(cfg), cfg.feat_dim
    arank = torch.cumsum(act.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = state.n_active + arank
    afits = act & (pos < A)
    adest = torch.where(afits, pos, A)
    vflat_c, _ = _flat_cell(vox_c - state.region_min, cfg.grid_dim)
    return state._replace(
        active_ids=_set_drop(state.active_ids, adest, vox_id),
        active_coords=_set_drop(state.active_coords, adest, vox_c),
        grid_active=_set_drop(state.grid_active, torch.where(afits, vflat_c, total), pos),
        packed=_set_drop(state.packed, adest, _pack(state.embeddings, c_lid2, Pc, F)),
        n_active=state.n_active + act.sum(dtype=torch.int32),
    )


def insert_points(state: MapState, cfg: MapConfig, points_world: torch.Tensor,
                  valid: torch.Tensor, cand_cap: int = 0,
                  append_active: bool = False) -> MapState:
    """K7. Replaces nerfloam_tpu/map/voxel_map.py:311-449 (insert_points):
    the XLA fusion of the two grid elections, the corner allocation, the
    activation and the active-set append. CPU tensors take the plain twin
    ``insert_points_plain``; CUDA tensors launch csrc/insert.cu, with the
    prefix sums between its passes in torch. The tables it writes are
    copies, so the input state stays valid (the pipeline rewinds to it on
    overflow). Same semantics and the same tables as the twin."""
    dev = points_world.device
    if dev.type == "cpu":
        return insert_points_plain(state, cfg, points_world, valid, cand_cap, append_active)
    if dev.type != "cuda":
        raise ValueError(f"insert_points: unsupported device {dev}")
    global insert_launches
    lib = kernels.lib()
    P = points_world.shape[0]
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    total = int(np.prod(cfg.grid_dim))
    Pc = cand_cap if 0 < cand_cap < P else P
    Dx, Dy, Dz = cfg.grid_dim
    i32 = dict(dtype=torch.int32, device=dev)
    pts = points_world.float().contiguous()
    val = valid.to(torch.bool).contiguous()
    rmin = state.region_min.to(torch.int32).contiguous()
    if any(t.device != dev for t in (val, rmin, state.grid, state.is_surface)):
        raise ValueError("insert_points: map and points must share one device")
    if F * 8 != state.packed.shape[1] or state.embeddings.dtype not in (torch.float32,
                                                                         torch.bfloat16):
        raise ValueError("insert_points: packed rows must be 8 x F float32 embeddings")
    stream = kernels.stream_ptr(dev)
    ptr = lambda t: t.data_ptr()  # noqa: E731

    winner = torch.full((total,), _INT_MAX, **i32)
    vox = torch.empty((P, 3), **i32)
    vflat = torch.empty((P,), **i32)
    kernels.check(lib.nl_insert_elect(ptr(pts), ptr(val), P, cfg.voxel_size, ptr(rmin), Dx, Dy,
                                      Dz, ptr(winner), ptr(vox), ptr(vflat), stream),
                  "insert_elect")
    cand = torch.empty((P,), **i32)
    kernels.check(lib.nl_insert_candidate(ptr(vflat), ptr(winner), ptr(state.grid),
                                          ptr(state.is_surface), P, ptr(cand), stream),
                  "insert_candidate")
    crank = torch.cumsum(cand, 0, dtype=torch.int32)
    num_cand = crank[-1].clone() if P else torch.zeros((), **i32)

    cwinner = winner.fill_(_INT_MAX)  # the first election is read; reuse its grid
    vox_c = torch.zeros((Pc, 3), **i32)
    cand_c = torch.zeros((Pc,), dtype=torch.bool, device=dev)
    cflat = torch.full((8 * Pc,), -1, **i32)
    kernels.check(lib.nl_insert_corners(ptr(vox), ptr(cand), ptr(crank), P, Pc, ptr(rmin), Dx,
                                        Dy, Dz, ptr(state.grid), ptr(cwinner), ptr(vox_c),
                                        ptr(cand_c), ptr(cflat), stream), "insert_corners")
    cnew = torch.empty((8 * Pc,), **i32)
    kernels.check(lib.nl_insert_corner_new(ptr(cflat), ptr(cwinner), 8 * Pc, ptr(cnew), stream),
                  "insert_corner_new")
    rank = torch.cumsum(cnew, 0, dtype=torch.int32)
    num_lat0 = state.num_lat.to(torch.int32).reshape(1).contiguous()
    lat_coords = state.lat_coords.clone()
    grid = state.grid.clone()
    kernels.check(lib.nl_insert_alloc(ptr(vox_c), ptr(cflat), ptr(cnew), ptr(rank), 8 * Pc,
                                      ptr(num_lat0), C, ptr(lat_coords), ptr(grid), stream),
                  "insert_alloc")
    num_lat = state.num_lat + (rank[-1] if Pc else 0)

    is_surface = state.is_surface.clone()
    corner_idx = state.corner_idx.clone()
    clid = torch.empty((Pc, 8), **i32)
    act = torch.empty((Pc,), **i32)
    kernels.check(lib.nl_insert_activate(ptr(vox_c), ptr(cand_c), Pc, ptr(rmin), Dx, Dy, Dz,
                                         ptr(grid), ptr(is_surface), ptr(corner_idx), ptr(clid),
                                         ptr(act), stream), "insert_activate")
    state = state._replace(lat_coords=lat_coords, grid=grid, num_lat=num_lat,
                           is_surface=is_surface, corner_idx=corner_idx, num_cand=num_cand)
    if append_active:
        arank = torch.cumsum(act, 0, dtype=torch.int32)
        n_active0 = state.n_active.to(torch.int32).reshape(1).contiguous()
        emb = state.embeddings.contiguous()
        active_ids = state.active_ids.clone()
        active_coords = state.active_coords.clone()
        grid_active = state.grid_active.clone()
        packed = state.packed.clone()
        kernels.check(lib.nl_insert_append(
            ptr(vox_c), ptr(act), ptr(arank), ptr(clid), Pc, ptr(n_active0), A, ptr(rmin), Dx,
            Dy, Dz, ptr(emb), int(emb.dtype == torch.bfloat16), F, ptr(active_ids),
            ptr(active_coords), ptr(grid_active), ptr(packed), stream), "insert_append")
        state = state._replace(active_ids=active_ids, active_coords=active_coords,
                               grid_active=grid_active, packed=packed,
                               n_active=state.n_active + (arank[-1] if Pc else 0))
    insert_launches += 1
    return state


def grow(state: MapState, cfg: MapConfig, new_capacity: int):
    """Host-driven capacity growth: copy rows into larger arrays."""
    new_cfg = cfg._replace(capacity=new_capacity)
    C = cfg.capacity
    big = create(new_cfg, state.grid.device)

    def put(dst, src):
        dst[:C] = src
        return dst

    return big._replace(
        lat_coords=put(big.lat_coords, state.lat_coords),
        is_surface=put(big.is_surface, state.is_surface),
        corner_idx=put(big.corner_idx, state.corner_idx),
        embeddings=put(big.embeddings, state.embeddings),
        num_lat=torch.clamp(state.num_lat, max=C),
        grid=state.grid,
        region_min=state.region_min,
        active_ids=state.active_ids,
        n_active=state.n_active,
        grid_active=state.grid_active,
        packed=state.packed,
        active_coords=state.active_coords,
        num_cand=state.num_cand,
        upd_count=put(big.upd_count, state.upd_count),
    ), new_cfg


def recenter_refresh(state: MapState, cfg: MapConfig, center_world: torch.Tensor) -> MapState:
    return refresh_active(recenter(state, cfg, center_world), cfg)


def needs_recenter(state: MapState, cfg: MapConfig, center_world: torch.Tensor,
                   margin: float) -> torch.Tensor:
    """() bool on the device: the sensor moved more than ``margin`` meters
    (max-abs over axes) from the current region center."""
    dims = torch.tensor(cfg.grid_dim, dtype=torch.int32, device=state.grid.device)
    region_center = (state.region_min + dims // 2).to(torch.float32) * cfg.voxel_size
    return torch.max(torch.abs(center_world - region_center)) > margin


def maybe_recenter_refresh(state: MapState, cfg: MapConfig, center_world: torch.Tensor,
                           margin: float) -> MapState:
    """Lazy recentering: rebuild only when ``needs_recenter``. JAX decides
    this on the device (lax.cond); here the branch costs one host read of a
    () bool per frame, which the pipeline counts in ``host_syncs``."""
    if bool(needs_recenter(state, cfg, center_world, margin)):
        return recenter_refresh(state, cfg, center_world)
    return state


def insert_frame(state: MapState, cfg: MapConfig, points_sensor: torch.Tensor,
                 points_cos: torch.Tensor, valid: torch.Tensor, pose6: torch.Tensor,
                 cand_cap: int = 0, append_active: bool = False) -> MapState:
    """World transform + insert (create_voxels, JAX voxel_map.py:535-575).
    With ``cfg.support_dist > 0`` each measured point also inserts a
    support point that far past the surface: straight down for ground
    points (cos < 0.999), along the ray otherwise; ``support_sym`` adds the
    mirror point on the sensor side. One insert_points pass takes all."""
    world = se3.transform_points(pose6, points_sensor)
    if cfg.support_dist <= 0:
        return insert_points(state, cfg, world, valid, cand_cap, append_active)
    dirs = points_sensor / (torch.linalg.norm(points_sensor, dim=-1, keepdim=True) + 1e-8)
    wdirs = se3.rotate_dirs(pose6, dirs)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=world.dtype, device=world.device)
    off = torch.where(points_cos[:, None] < 0.999, down[None, :], wdirs)
    pts = [world, world + off * cfg.support_dist]
    if cfg.support_sym:
        pts.append(world - off * cfg.support_dist)
    return insert_points(state, cfg, torch.cat(pts, 0), torch.cat([valid] * len(pts), 0),
                         cand_cap, append_active)
