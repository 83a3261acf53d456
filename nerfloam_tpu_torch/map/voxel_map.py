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

Plain torch in this slice. The map-maintenance fusions wait for later
kernels: K5 (``reconcile_packed``, ``bump_upd_count``, ``pack_embeddings``),
K6 (``recenter``, ``refresh_active``) and K7 (``insert_points``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.interp import CORNER_OFFSETS


class MapConfig(NamedTuple):
    """Static map parameters."""

    capacity: int
    grid_dim: tuple
    voxel_size: float
    feat_dim: int = 16
    emb_dtype: str = "float32"  # "float32" | "bfloat16"
    active_cap: int = 0         # 0 -> capacity


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


def create(cfg: MapConfig, device="cpu") -> MapState:
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


def insert_points(state: MapState, cfg: MapConfig, points_world: torch.Tensor,
                  valid: torch.Tensor, cand_cap: int = 0,
                  append_active: bool = False) -> MapState:
    """Allocate voxels (and their corner lattice points) at observed points:
    each observed voxel becomes surface, its 8 corners are allocated if
    absent. Duplicates are resolved by a grid scatter followed by a read
    back ("election"): any duplicate may win, and the read back agrees with
    whichever did. Out-of-region points are dropped; rows past capacity are
    dropped and their voxels stay inactive while ``num_lat`` still counts
    them, so the host can grow the map."""
    dev = points_world.device
    P = points_world.shape[0]
    C = cfg.capacity
    total = int(np.prod(cfg.grid_dim))
    i32 = dict(dtype=torch.int32, device=dev)

    vox = torch.floor(points_world / cfg.voxel_size).to(torch.int32)
    vflat, vox_inb = _flat_cell(vox - state.region_min, cfg.grid_dim)
    ok = valid & vox_inb
    slot = torch.arange(P, **i32)
    winner = _set_drop(torch.full((total,), -1, **i32), torch.where(ok, vflat, total), slot)
    first = ok & (winner[torch.clamp(vflat, 0, total - 1).long()] == slot)

    lid0 = lookup(state, cfg, vox)
    already_surface = (lid0 >= 0) & state.is_surface[torch.clamp(lid0, min=0).long()]
    cand = first & ~already_surface
    num_cand = cand.sum(dtype=torch.int32)

    if cand_cap and cand_cap < P:
        Pc = cand_cap
        crank = torch.cumsum(cand.to(torch.int32), 0, dtype=torch.int32) - 1
        keep = cand & (crank < Pc)
        cdest = torch.where(keep, crank, Pc)
        vox_c = _set_drop(torch.zeros((Pc, 3), **i32), cdest, vox)
        cand_c = _set_drop(torch.zeros((Pc,), dtype=torch.bool, device=dev), cdest, keep)
    else:
        vox_c, cand_c = vox, cand
    Pc = vox_c.shape[0]

    offsets = torch.as_tensor(CORNER_OFFSETS, device=dev)
    corners = vox_c[:, None, :] + offsets[None]
    cflat3 = corners.reshape(-1, 3)
    c_flatidx, c_inb = _flat_cell(cflat3 - state.region_min, cfg.grid_dim)
    c_lid = lookup(state, cfg, cflat3)
    c_ok = torch.repeat_interleave(cand_c, 8) & c_inb & (c_lid < 0)
    cslot = torch.arange(8 * Pc, **i32)
    cwinner = _set_drop(torch.full((total,), -1, **i32), torch.where(c_ok, c_flatidx, total), cslot)
    cnew = c_ok & (cwinner[torch.clamp(c_flatidx, 0, total - 1).long()] == cslot)

    ranks = torch.cumsum(cnew.to(torch.int32), 0, dtype=torch.int32) - 1
    new_ids = state.num_lat + ranks
    fits = new_ids < C
    lat_coords = _set_drop(state.lat_coords, torch.where(cnew & fits, new_ids, C), cflat3)
    grid = _set_drop(state.grid, torch.where(cnew & fits, c_flatidx, total),
                     torch.where(fits, new_ids, -1))
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
    """World transform + insert (create_voxels); support voxels are not
    ported yet (ROADMAP queue 1, item 10)."""
    world = se3.transform_points(pose6, points_sensor)
    return insert_points(state, cfg, world, valid, cand_cap, append_active)

