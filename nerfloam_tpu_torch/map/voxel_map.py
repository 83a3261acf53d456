"""Device-resident sparse voxel map (port of nerfloam_tpu/map/voxel_map.py).

One row per lattice point (= octree corner octant); ``is_surface`` marks
directly observed voxels and ``corner_idx`` holds each surface voxel's 8
corner rows. Spatial lookup goes through a dense region-local grid rebuilt
around the sensor. Every function keeps the JAX version's static shapes,
so a frame never waits on the host: out-of-range writes that JAX drops
(``mode="drop"``) go to one trash row appended to the target and sliced
off (``_set_drop`` / ``_add_drop``).

Functions return a new ``MapState`` rather than editing their input, like
the JAX code, but one: ``insert_points`` (and ``insert_frame``) writes
into the state it is given and returns ``(state, record)``;
``undo_insert(state, record)`` puts it back exactly. The pipeline undoes
an insert before it rewinds a frame for an overflow replay; any other
caller that needs the pre-insert state clones it first.

Kernels, each with a plain torch twin that CPU tensors take: K7
``insert_points`` and its ``undo_insert`` (csrc/insert.cu, twins
``insert_points_plain`` and ``undo_insert_plain``, in place too; its
scratch an ``InsertScratch`` the pipeline keeps); K6 ``recenter`` and
``refresh_active`` (csrc/active_set.cu, twins ``recenter_plain`` and
``refresh_active_plain``); K5 ``reconcile``, the BA step's tail
(csrc/reconcile.cu, twin ``reconcile_plain``, which runs the JAX-named
pieces ``reconcile_packed``, ``bump_upd_count`` and ``pack_embeddings``;
its scratch a ``ReconcileScratch`` the pipeline keeps); E1
``PackEmbeddings``, the exact-gradient BA step's repack as an autograd
function: its forward ``pack_embeddings_fwd`` (the pack pass of
csrc/active_set.cu, twin ``pack_embeddings``) and its transpose
``pack_embeddings_vjp`` (csrc/pack_grad.cu, twin
``pack_embeddings_vjp_plain``; its scratch a ``PackGradScratch`` built
once a step). K6 and K5 write fresh tables, so a kept state stays valid
across them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.ieee import (  # noqa: F401 (div, rdiv re-exported)
    const, div, norm3, rdiv)
from nerfloam_tpu_torch.ops.interp import CORNER_OFFSETS

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
insert_launches = 0      # K7
insert_undo_launches = 0  # K7's undo_insert
active_set_launches = 0  # K6: recenter and refresh_active, one each
reconcile_launches = 0   # K5
pack_embeddings_launches = 0  # E1's forward
pack_grad_launches = 0        # E1's transpose
pack_grad_build_launches = 0  # its scratch built for a BA step
RECONCILE_MODES = ("mean", "sum")
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


def _add_in_order(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``target.at[idx].add(values, mode="drop")`` as XLA applies it: one
    index at a time in ascending order, rounding to target's dtype after
    every add (a bf16 ``index_add_`` on the CPU sums duplicates in f32 and
    rounds once instead). Duplicates are split into rounds of distinct
    indices by their occurrence number; indices outside the target drop."""
    idx = idx.long()
    keep = torch.nonzero((idx >= 0) & (idx < target.shape[0])).squeeze(1)
    ci, vals = idx[keep], values[keep].to(target.dtype)
    sorted_c, order = torch.sort(ci, stable=True)
    occ = torch.empty_like(order)
    occ[order] = torch.arange(len(order), device=idx.device) - torch.searchsorted(sorted_c,
                                                                                   sorted_c)
    out = target.clone()
    for o in range(int(occ.max()) + 1 if len(occ) else 0):
        m = occ == o
        out.index_add_(0, ci[m], vals[m])
    return out


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


def _region_min(cfg: MapConfig, center_world: torch.Tensor) -> torch.Tensor:
    dims = const(tuple(cfg.grid_dim), torch.int32, center_world.device)
    return torch.floor(div(center_world.float(), cfg.voxel_size)).to(torch.int32) - dims // 2


def _device_of(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _emb_args(emb: torch.Tensor):
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("map kernels take float32 or bfloat16 embeddings")
    return emb.contiguous(), int(emb.dtype == torch.bfloat16)


def recenter_plain(state: MapState, cfg: MapConfig, center_world: torch.Tensor) -> MapState:
    """Plain torch twin of K6's recenter: rebuild the dense grid around a
    new world-space center (one scatter over the lattice table)."""
    dev = state.grid.device
    region_min = _region_min(cfg, center_world)
    total = int(np.prod(cfg.grid_dim))
    ids = torch.arange(cfg.capacity, dtype=torch.int32, device=dev)
    flat, inb = _flat_cell(state.lat_coords - region_min, cfg.grid_dim)
    ok = inb & (ids < state.num_lat)
    grid = _set_drop(torch.full((total,), -1, dtype=torch.int32, device=dev),
                     torch.where(ok, flat, total), ids)
    return state._replace(grid=grid, region_min=region_min)


def recenter(state: MapState, cfg: MapConfig, center_world: torch.Tensor) -> MapState:
    """K6, first half. Replaces nerfloam_tpu/map/voxel_map.py:149-169
    (recenter): the scatter of the lattice table into a fresh region grid.
    CPU tensors take ``recenter_plain``; CUDA tensors launch
    csrc/active_set.cu (fill, then one thread per lattice row). Writes a
    new grid; the input state stays valid."""
    if _device_of("recenter", state.grid).type == "cpu":
        return recenter_plain(state, cfg, center_world)
    global active_set_launches
    dev = state.grid.device
    region_min = _region_min(cfg, center_world.to(dev)).contiguous()
    grid = torch.empty((int(np.prod(cfg.grid_dim)),), dtype=torch.int32, device=dev)
    lat, num_lat = state.lat_coords.contiguous(), state.num_lat.to(torch.int32).reshape(1)
    kernels.check(kernels.lib().nl_recenter(
        lat.data_ptr(), num_lat.data_ptr(), cfg.capacity, region_min.data_ptr(), *cfg.grid_dim,
        grid.data_ptr(), kernels.stream_ptr(dev)), "recenter")
    active_set_launches += 1
    return state._replace(grid=grid, region_min=region_min)


def refresh_active_plain(state: MapState, cfg: MapConfig) -> MapState:
    """Plain torch twin of K6's refresh: rebuild the active surface set,
    grid_active and the packed (A, 8F) corner table from the in-region
    surface voxels."""
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


def refresh_active(state: MapState, cfg: MapConfig) -> MapState:
    """K6, second half. Replaces nerfloam_tpu/map/voxel_map.py:183-225
    (refresh_active): mark the in-region surface rows, rank them (inclusive
    torch.cumsum between the passes), place them in ascending lattice id
    (active_ids, grid_active) and gather their packed rows and coords.
    CPU tensors take ``refresh_active_plain``; CUDA tensors launch
    csrc/active_set.cu. ``n_active`` is the true count (it may exceed A).
    Writes fresh tables; the input state stays valid."""
    if _device_of("refresh_active", state.grid).type == "cpu":
        return refresh_active_plain(state, cfg)
    global active_set_launches
    lib = kernels.lib()
    dev = state.grid.device
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    i32 = dict(dtype=torch.int32, device=dev)
    stream = kernels.stream_ptr(dev)
    lat = state.lat_coords.contiguous()
    rmin = state.region_min.to(torch.int32).contiguous()
    num_lat = state.num_lat.to(torch.int32).reshape(1)
    emb, bf16 = _emb_args(state.embeddings)
    _pack_check("refresh_active", emb, A, F)
    act = torch.empty((C,), **i32)
    grid_active = torch.empty((int(np.prod(cfg.grid_dim)),), **i32)
    active_ids = torch.empty((A,), **i32)
    kernels.check(lib.nl_refresh_mark(lat.data_ptr(), state.is_surface.contiguous().data_ptr(),
                                      num_lat.data_ptr(), C, rmin.data_ptr(), *cfg.grid_dim, A,
                                      act.data_ptr(), grid_active.data_ptr(),
                                      active_ids.data_ptr(), stream), "refresh_mark")
    rank = torch.cumsum(act, 0, dtype=torch.int32)
    kernels.check(lib.nl_refresh_place(lat.data_ptr(), act.data_ptr(), rank.data_ptr(), C,
                                       rmin.data_ptr(), *cfg.grid_dim, A, grid_active.data_ptr(),
                                       active_ids.data_ptr(), stream), "refresh_place")
    packed = torch.empty((A, 8 * F), dtype=torch.float32, device=dev)
    active_coords = torch.empty((A, 3), **i32)
    cidx = state.corner_idx.contiguous()
    kernels.check(lib.nl_active_pack(active_ids.data_ptr(), cidx.data_ptr(),
                                     emb.data_ptr(), bf16, A, F, lat.data_ptr(), packed.data_ptr(),
                                     active_coords.data_ptr(), stream), "active_pack")
    active_set_launches += 1
    return state._replace(active_ids=active_ids, n_active=rank[-1].clone(),
                          grid_active=grid_active, packed=packed, active_coords=active_coords)


def _pack(embeddings: torch.Tensor, cidx: torch.Tensor, n: int, F: int) -> torch.Tensor:
    return embeddings[torch.clamp(cidx, min=0).long()].float().reshape(n, 8 * F)


def _check_mode(mode: str):
    if mode not in RECONCILE_MODES:
        raise ValueError(f"reconcile mode must be 'mean' or 'sum', got {mode!r}")


def reconcile_packed(state: MapState, cfg: MapConfig, new_packed: torch.Tensor,
                     touched: torch.Tensor, touched_cap: int, mode: str = "mean") -> torch.Tensor:
    """Plain piece of K5's twin: fold the optimized packed-copy deltas of
    the touched voxels back into the canonical (C, F) embeddings; a corner
    shared by k touched voxels gets the mean ("mean") or the sum ("sum")
    of its k deltas, added in ascending (rank, corner slot) order on the
    CPU. Returns the new embeddings."""
    _check_mode(mode)
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
    if mode == "mean":
        mult = _add_drop(torch.zeros((C,), dtype=torch.float32, device=dev), cflat,
                         torch.ones_like(cflat, dtype=torch.float32))
        delta = delta / torch.clamp(mult[torch.clamp(cflat, 0, C - 1).long()], min=1.0)[:, None]
    # cast the f32 deltas to the embedding type BEFORE adding, as JAX does
    return _add_in_order(state.embeddings, cflat, delta.to(state.embeddings.dtype))


def bump_upd_count(state: MapState, cfg: MapConfig, touched: torch.Tensor) -> torch.Tensor:
    """Plain piece of K5's twin: (C,) upd_count + 1 at every active voxel
    row touched this BA step."""
    dest = torch.where(touched, state.active_ids, cfg.capacity)
    return _add_drop(state.upd_count, dest, torch.ones_like(dest))


def pack_embeddings(state: MapState, cfg: MapConfig) -> torch.Tensor:
    """Plain piece of K5's twin: (A, 8F) packed corner features from the
    current embeddings."""
    A = acap(cfg)
    return _pack(state.embeddings, state.corner_idx[state.active_ids.long()], A, cfg.feat_dim)


class Reconciled(NamedTuple):
    embeddings: torch.Tensor     # (C, F) with the touched voxels' deltas folded in
    packed: torch.Tensor         # (A, 8F) repacked from them
    upd_count: torch.Tensor      # (C,) + 1 at every touched voxel
    touched_count: torch.Tensor  # () int32 voxels touched (may exceed touched_cap)


def reconcile_plain(state: MapState, cfg: MapConfig, new_packed: torch.Tensor,
                    touched: torch.Tensor, touched_cap: int, mode: str = "mean") -> Reconciled:
    """Plain torch twin of K5: bump_upd_count, reconcile_packed and
    pack_embeddings in a row (the tail of JAX core/ba.py:378-391)."""
    emb = reconcile_packed(state, cfg, new_packed, touched, touched_cap, mode)
    return Reconciled(emb, pack_embeddings(state._replace(embeddings=emb), cfg),
                      bump_upd_count(state, cfg, touched), touched.sum(dtype=torch.int32))


class ReconcileScratch:
    """K5's scratch, owned by its caller: the pipeline keeps one for the
    run and hands it to every BA step (``ba_step(reconcile_scratch=)``), so
    the (C,) head table is filled with -1 once per map capacity, not once
    per step. It holds that table (every call leaves it all -1: the head of
    each corner's list resets its entry), the scan's tile states and its
    ticket (int64, the ticket last; left at zero), and the compacted rows
    and contribution lists for up to T kept rows. It is allocated at its
    first call on the card, again for a call with a larger map (``grow``),
    more active rows or a larger cap, and dropped by a call whose launch
    fails (the next call starts afresh). Calls on one stream take turns
    with it."""

    def __init__(self):
        self.drop()

    def fit(self, dev, C: int, A: int, T: int):
        """The kernels' scratch pointers (head, tile states, ticket, t_rows,
        t_ids, cid, next) for C map rows, A active rows and T kept rows on
        dev."""
        tiles = kernels.lib().nl_reconcile_scan_tiles(A)
        if self.ptrs is None or dev != self.dev or C > self.C or tiles > self.tiles or T > self.T:
            C, tiles, T = max(C, self.C), max(tiles, self.tiles), max(T, self.T, 1)
            i32 = dict(dtype=torch.int32, device=dev)
            self.head = torch.full((C,), -1, **i32)
            self.scan_state = torch.zeros((tiles + 1,), dtype=torch.int64, device=dev)
            self._lists = (torch.empty((T,), **i32), torch.empty((T,), **i32),
                           torch.empty((8 * T,), **i32),
                           torch.empty((8 * T,), **i32))  # t_rows, t_ids, cid, next
            self.C, self.tiles, self.T, self.dev = C, tiles, T, dev
            state = self.scan_state.data_ptr()
            self.ptrs = (self.head.data_ptr(), state, state + 8 * tiles,
                         *[t.data_ptr() for t in self._lists])
        return self.ptrs

    def drop(self):
        self.C = self.tiles = self.T = 0
        self.dev = self.ptrs = self.head = self.scan_state = self._lists = None


def _pack_check(name: str, emb: torch.Tensor, A: int, F: int):
    """The pack pass's limits: F a multiple of 4 (float4 stores), 32-bit
    indices (A * 8F < 2^31) and 16-byte aligned embedding rows."""
    if F % 4 or A * 8 * F >= 2**31 or emb.data_ptr() % 16:
        raise ValueError(f"{name}: the pack pass needs feat_dim % 4 == 0 (got {F}), A * 8F < "
                         f"2^31 (got {A * 8 * F}) and 16-byte aligned embeddings")


def reconcile(state: MapState, cfg: MapConfig, new_packed: torch.Tensor, touched: torch.Tensor,
              touched_cap: int, scratch: ReconcileScratch | None = None,
              mode: str = "mean") -> Reconciled:
    """K5. Replaces nerfloam_tpu/map/voxel_map.py:233-308 (reconcile_packed
    in ``mode`` "mean" or "sum", bump_upd_count, pack_embeddings) as one BA
    step's tail calls them: rank and compact the touched rows to
    ``touched_cap`` in one pass (a decoupled look-back scan, which also
    bumps their counts), link each corner's contributions, fold them in
    ascending (rank, corner slot) order with the delta (divided by the
    corner's multiplicity in "mean" mode) cast to the embedding type before
    every add, then repack all A rows. Deterministic: two calls give bit-identical tables.
    CPU tensors take ``reconcile_plain``; CUDA tensors launch
    csrc/reconcile.cu (three kernels) and the pack pass of
    csrc/active_set.cu, on inputs as the kernels read them (contiguous; the
    touched mask bool, new and old packed (A, 128) f32, active_ids,
    corner_idx and upd_count int32, f32 or bf16 embeddings of 16 features):
    nothing is converted, anything else raises ValueError. ``scratch``: a
    ``ReconcileScratch`` kept by the caller (without one, one made for this
    call: a (C,) fill).

    The embeddings and update counts come back as fresh copies (64 + 8 MB
    at C = 2,097,152): the kernels fold into those copies, not into the
    state's tables, because the pipeline replays a BA step whose touched
    count overflowed its cap from the state it started from
    (``NerfLoamSLAM_torch.do_mapping``)."""
    _check_mode(mode)
    if _device_of("reconcile", new_packed).type == "cpu":
        return reconcile_plain(state, cfg, new_packed, touched, touched_cap, mode)
    global reconcile_launches
    name = "reconcile"
    dev = new_packed.device
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    T = min(touched_cap, A)  # no more rows can be kept
    if F != 16:
        raise ValueError(f"{name}: packed rows must be 8 x 16 floats")
    if state.embeddings.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: embeddings must be float32 or bfloat16")
    kernels.expect(name, dev, torch.bool, touched=touched)
    kernels.expect(name, dev, torch.float32, new_packed=new_packed, packed=state.packed)
    kernels.expect(name, dev, torch.int32, active_ids=state.active_ids,
                   corner_idx=state.corner_idx, upd_count=state.upd_count)
    kernels.expect(name, dev, state.embeddings.dtype, embeddings=state.embeddings)
    kernels.expect_shape(name, touched=(touched, (A,)), new_packed=(new_packed, (A, 8 * F)),
                         packed=(state.packed, (A, 8 * F)), active_ids=(state.active_ids, (A,)),
                         corner_idx=(state.corner_idx, (C, 8)),
                         upd_count=(state.upd_count, (C,)),
                         embeddings=(state.embeddings, (C, F)))
    if new_packed.data_ptr() % 16 or state.packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed rows must be 16-byte aligned")
    _pack_check(name, state.embeddings, A, F)
    lib = kernels.lib()
    scratch = ReconcileScratch() if scratch is None else scratch
    ptrs = scratch.fit(dev, C, A, T)
    stream = kernels.stream_ptr(dev)
    upd_count = state.upd_count.clone()
    emb = state.embeddings.clone()
    count = torch.empty((), dtype=torch.int32, device=dev)
    packed = torch.empty((A, 8 * F), dtype=torch.float32, device=dev)
    active_ids, corner_idx = state.active_ids.data_ptr(), state.corner_idx.data_ptr()
    bf16 = int(emb.dtype == torch.bfloat16)
    err = lib.nl_reconcile(touched.data_ptr(), active_ids, corner_idx, new_packed.data_ptr(),
                           state.packed.data_ptr(), A, T, C, emb.data_ptr(), bf16,
                           int(mode == "sum"), upd_count.data_ptr(), count.data_ptr(), *ptrs,
                           stream)
    if err:
        scratch.drop()  # its head table and tile states may not be reset
        kernels.check(err, name)
    kernels.check(lib.nl_active_pack(active_ids, corner_idx, emb.data_ptr(), bf16, A, F, None,
                                     packed.data_ptr(), None, stream), "active_pack")
    reconcile_launches += 1
    return Reconciled(emb, packed, upd_count, count)


# ---------------------------------------------------------------- E1


def pack_embeddings_fwd(state: MapState, cfg: MapConfig, embeddings: torch.Tensor) -> torch.Tensor:
    """E1's forward. Replaces nerfloam_tpu/map/voxel_map.py:301-308
    (pack_embeddings) as the exact-gradient BA step calls it on its (C, F)
    parameter ``embeddings``: the (A, 8F) f32 packed rows of the state's
    active set. CPU tensors take ``pack_embeddings``; CUDA tensors launch
    the pack pass of csrc/active_set.cu (a warp a row), on inputs as it
    reads them (f32 or bf16 (C, 16) embeddings and int32 active_ids and
    corner_idx, contiguous): anything else raises ValueError."""
    if _device_of("pack_embeddings", embeddings).type == "cpu":
        return pack_embeddings(state._replace(embeddings=embeddings), cfg)
    global pack_embeddings_launches
    name = "pack_embeddings"
    dev = embeddings.device
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    if embeddings.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: embeddings must be float32 or bfloat16")
    kernels.expect(name, dev, embeddings.dtype, embeddings=embeddings)
    kernels.expect(name, dev, torch.int32, active_ids=state.active_ids,
                   corner_idx=state.corner_idx)
    kernels.expect_shape(name, embeddings=(embeddings, (C, F)),
                         active_ids=(state.active_ids, (A,)), corner_idx=(state.corner_idx, (C, 8)))
    _pack_check(name, embeddings, A, F)
    packed = torch.empty((A, 8 * F), dtype=torch.float32, device=dev)
    kernels.check(kernels.lib().nl_active_pack(
        state.active_ids.data_ptr(), state.corner_idx.data_ptr(), embeddings.data_ptr(),
        int(embeddings.dtype == torch.bfloat16), A, F, None, packed.data_ptr(), None,
        kernels.stream_ptr(dev)), name)
    pack_embeddings_launches += 1
    return packed


def pack_embeddings_vjp_plain(d_packed: torch.Tensor, active_ids: torch.Tensor,
                              corner_idx: torch.Tensor, n_active, capacity: int) -> torch.Tensor:
    """Plain torch twin of E1's transpose: d embeddings (C, F) f32 from d
    packed (A, 8F) f32, each entry (row a, slot s) of the first
    min(n_active, A) rows added into its corner max(corner_idx[
    active_ids[a], s], 0) in ascending (a, s), from 0, rounded after
    every add (XLA's scatter order). The padding rows past them are left
    out: no sample reaches them, so their d packed is zero."""
    A = active_ids.shape[0]
    F = d_packed.shape[1] // 8
    n = min(int(n_active), A)
    idx = torch.clamp(corner_idx[active_ids[:n].long()], min=0).reshape(-1)
    zero = torch.zeros((capacity, F), dtype=torch.float32, device=d_packed.device)
    return _add_in_order(zero, idx, d_packed[:n].reshape(-1, F))


class PackGradScratch:
    """E1's transpose prepared for one BA step, owned by its caller (the
    pipeline keeps one for the run and hands it to every exact-gradient
    BA step, ``ba_step(pack_scratch=)``): ``build(state, cfg)`` takes the
    step's active set and, on the card, links every corner's entries and
    sorts each list once (csrc/pack_grad.cu, two launches), so that each
    backward of the step is one launch. It holds the (C,) head table (all
    -1 between builds: the sort pass resets it), the (8A,) links, and the
    sorted heads (C,) and links (8A,). Buffers are allocated at the first
    build on the card and again for a larger map (``grow``) or active
    set; a build whose launch fails drops them. A backward reads the
    lists of the last build: calls on one stream take turns with it. CPU
    tensors need no buffers: a build keeps the state for the plain
    twin."""

    def __init__(self):
        self.drop()

    def build(self, state: MapState, cfg: MapConfig) -> "PackGradScratch":
        global pack_grad_build_launches
        name = "pack_embeddings_vjp"
        C, A = cfg.capacity, acap(cfg)
        dev = _device_of(name, state.active_ids)
        self.C, self.state = C, state
        if dev.type == "cpu":
            return self
        kernels.expect(name, dev, torch.int32, active_ids=state.active_ids,
                       corner_idx=state.corner_idx, n_active=state.n_active)
        kernels.expect_shape(name, active_ids=(state.active_ids, (A,)),
                             corner_idx=(state.corner_idx, (C, 8)), n_active=(state.n_active, ()))
        if 8 * A * 16 >= 2**31:
            raise ValueError(f"{name}: A * 128 < 2^31 needed (got A = {A})")
        if self._bufs is None or dev != self.dev or C > self.cap_c or A > self.cap_a:
            i32 = dict(dtype=torch.int32, device=dev)
            self.cap_c, self.cap_a = max(C, self.cap_c), max(A, self.cap_a)
            c, e = self.cap_c, 8 * self.cap_a
            self._bufs = (torch.full((c,), -1, **i32), torch.empty((e,), **i32),
                          torch.empty((c,), **i32), torch.empty((e,), **i32))
            self.dev = dev
        head, nxt, self.shead, self.snext = self._bufs
        err = kernels.lib().nl_pack_grad_build(
            state.active_ids.data_ptr(), state.corner_idx.data_ptr(), state.n_active.data_ptr(),
            A, C, head.data_ptr(), nxt.data_ptr(), self.shead.data_ptr(), self.snext.data_ptr(),
            kernels.stream_ptr(dev))
        if err:
            self.drop()  # its head table may not be reset
            kernels.check(err, name)
        pack_grad_build_launches += 1
        return self

    def drop(self):
        self.C = self.cap_c = self.cap_a = 0
        self.dev = self.state = self._bufs = self.shead = self.snext = None


def pack_embeddings_vjp(d_packed: torch.Tensor, scratch: PackGradScratch) -> torch.Tensor:
    """E1's transpose. Replaces the scatter-add XLA emits for the gather of
    nerfloam_tpu/map/voxel_map.py:301-308 under jax.value_and_grad
    (core/ba.py:222-227): d embeddings (C, 16) f32 from d packed (A, 128)
    f32, over the lists of ``scratch``'s last build. Each corner adds its
    entries in ascending (row, slot) from 0, with no float atomics: two
    calls give bit-identical tables, equal to ``pack_embeddings_vjp_plain``
    (which CPU tensors take). On the card one launch of csrc/pack_grad.cu,
    four threads a corner; d packed must be contiguous, 16-byte aligned
    f32 (A, 128) on the scratch's device, or ValueError."""
    name = "pack_embeddings_vjp"
    if scratch.state is None:
        raise ValueError(f"{name}: the scratch has not been built for this step")
    st, C = scratch.state, scratch.C
    if _device_of(name, d_packed).type == "cpu":
        return pack_embeddings_vjp_plain(d_packed, st.active_ids, st.corner_idx, st.n_active, C)
    global pack_grad_launches
    dev = d_packed.device
    if scratch.dev != dev:
        raise ValueError(f"{name}: d_packed on {dev}, the scratch built on {scratch.dev}")
    kernels.expect(name, dev, torch.float32, d_packed=d_packed)
    kernels.expect_shape(name, d_packed=(d_packed, (st.active_ids.shape[0], 128)))
    if d_packed.data_ptr() % 16:
        raise ValueError(f"{name}: d_packed rows must be 16-byte aligned")
    d_emb = torch.empty((C, 16), dtype=torch.float32, device=dev)
    kernels.check(kernels.lib().nl_pack_grad(d_packed.data_ptr(), scratch.shead.data_ptr(),
                                             scratch.snext.data_ptr(), C, d_emb.data_ptr(),
                                             kernels.stream_ptr(dev)), name)
    pack_grad_launches += 1
    return d_emb


class PackEmbeddings(torch.autograd.Function):
    """E1 as the exact-gradient BA step differentiates it:
    ``PackEmbeddings.apply(embeddings, state, cfg, scratch)`` is
    ``pack_embeddings_fwd(state, cfg, embeddings)``, and its backward
    ``pack_embeddings_vjp(d_packed, scratch)`` (the scratch built for the
    step's state)."""

    @staticmethod
    def forward(ctx, embeddings, state, cfg, scratch):
        ctx.scratch = scratch
        return pack_embeddings_fwd(state, cfg, embeddings)

    @staticmethod
    def backward(ctx, d_packed):
        return pack_embeddings_vjp(d_packed.contiguous(), ctx.scratch), None, None, None


class InsertRecord(NamedTuple):
    """What one ``insert_points`` call overwrote, for ``undo_insert``.
    ``ints`` (int32): a header of 8 words (num_lat, n_active and num_cand
    before the call, then the rows, activated voxels and appended slots it
    wrote), then ``rows`` x 5 (the new rows from the old num_lat on: their
    old coords, grid cell and old grid entry), ``cands`` x 10 (the
    activated voxels in candidate order: row, old surface flag, old corner
    rows) and ``slots`` x 6 (the appended slots from the old n_active on:
    old id, old coords, grid_active cell, old entry); ``packed`` (slots,
    8F) f32, their old packed rows. Only the counted prefix of each part is
    written; ``record_parts`` cuts it out."""

    ints: torch.Tensor
    packed: torch.Tensor
    rows: int
    cands: int
    slots: int


_HEADER = 8


def _new_record(dev, cfg: MapConfig, Pc: int, append_active: bool, make=torch.empty):
    R, Aa = min(8 * Pc, cfg.capacity), min(Pc, acap(cfg)) if append_active else 0
    ints = make((_HEADER + 5 * R + 10 * Pc + 6 * Aa,), dtype=torch.int32, device=dev)
    return InsertRecord(ints, make((Aa, 8 * cfg.feat_dim), dtype=torch.float32, device=dev),
                        R, Pc, Aa)


def _record_views(rec: InsertRecord):
    """(header, rows (R, 5), cands (Pc, 10), slots (Aa, 6)) views of ints."""
    R, Pc, Aa = rec.rows, rec.cands, rec.slots
    h, rows, cands, slots = rec.ints.split_with_sizes([_HEADER, 5 * R, 10 * Pc, 6 * Aa])
    return h, rows.view(R, 5), cands.view(Pc, 10), slots.view(Aa, 6)


def record_parts(rec: InsertRecord) -> dict:
    """The written part of a record (one host read of its header): the
    old scalars and counts, and the rows, activated voxels, appended slots
    and their old packed rows."""
    h, rows, cands, slots = _record_views(rec)
    n_rows, n_act, n_app = h[3:6].tolist()
    return {"header": h[:6], "rows": rows[:n_rows], "activated": cands[:n_act],
            "appended": slots[:n_app], "packed": rec.packed[:n_app]}


def insert_points_plain(state: MapState, cfg: MapConfig, points_world: torch.Tensor,
                        valid: torch.Tensor, cand_cap: int = 0, append_active: bool = False):
    """Plain torch twin of K7: allocate voxels (and their corner lattice
    points) at observed points, in place, returning ``(state, record)``
    as ``insert_points`` does. Each observed voxel becomes surface, its 8
    corners are allocated if absent. Duplicates are resolved by electing
    the smallest point (corner) slot per grid cell (JAX lets any duplicate
    win, so its row ids differ but its sets are the same). Candidates are
    compacted to ``cand_cap`` rows (all P when 0 or >= P) before the corner
    pass. Out-of-region points are dropped; rows past capacity are dropped
    and their voxels stay inactive while ``num_lat`` still counts them, so
    the host can grow the map."""
    dev = points_world.device
    P = points_world.shape[0]
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    total = int(np.prod(cfg.grid_dim))
    i32 = dict(dtype=torch.int32, device=dev)
    Pc = cand_cap if 0 < cand_cap < P else P
    rec = _new_record(dev, cfg, Pc, append_active, torch.zeros)
    h, rec_rows, rec_act, rec_app = _record_views(rec)
    num_lat0, n_active0, num_cand0 = (int(x) for x in (state.num_lat, state.n_active,
                                                       state.num_cand))

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
    num_cand = int(cand.sum())

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

    # the new corners take rows num_lat0 + rank, in ascending slot
    new_ids = num_lat0 + torch.cumsum(cnew.to(torch.int32), 0, dtype=torch.int32) - 1
    put = cnew & (new_ids < C)
    ids, cells = new_ids[put].long(), c_flatidx[put].long()
    n_rows = len(ids)
    rec_rows[:n_rows, :3] = state.lat_coords[ids]
    rec_rows[:n_rows, 3] = cells.to(torch.int32)
    rec_rows[:n_rows, 4] = state.grid[cells]
    state.lat_coords[ids] = cflat3[put]
    state.grid[cells] = ids.to(torch.int32)
    state.num_lat.fill_(num_lat0 + int(cnew.sum()))
    state.num_cand.fill_(num_cand)

    c_lid2 = lookup(state, cfg, corners)
    act = cand_c & torch.all(c_lid2 >= 0, dim=-1)
    vids = c_lid2[act, 0].long()
    n_act = len(vids)
    rec_act[:n_act, 0] = vids.to(torch.int32)
    rec_act[:n_act, 1] = state.is_surface[vids].to(torch.int32)
    rec_act[:n_act, 2:] = state.corner_idx[vids]
    state.is_surface[vids] = True
    state.corner_idx[vids] = c_lid2[act]
    n_app = 0
    if append_active:  # the newly activated voxels join the active set (lazy recentering)
        n_app = max(0, min(n_active0 + n_act, A) - n_active0)
        pos = torch.arange(n_active0, n_active0 + n_app, device=dev)
        vflat_c, _ = _flat_cell(vox_c[act][:n_app] - state.region_min, cfg.grid_dim)
        cells = vflat_c.long()
        rec_app[:n_app, 0] = state.active_ids[pos]
        rec_app[:n_app, 1:4] = state.active_coords[pos]
        rec_app[:n_app, 4] = cells.to(torch.int32)
        rec_app[:n_app, 5] = state.grid_active[cells]
        rec.packed[:n_app] = state.packed[pos]
        state.active_ids[pos] = vids[:n_app].to(torch.int32)
        state.active_coords[pos] = vox_c[act][:n_app]
        state.grid_active[cells] = pos.to(torch.int32)
        state.packed[pos] = _pack(state.embeddings, c_lid2[act][:n_app], n_app, F)
        state.n_active.fill_(n_active0 + n_act)
    h[:6] = torch.tensor([num_lat0, n_active0, num_cand0, n_rows, n_act, n_app], **i32)
    return state, rec


class InsertScratch:
    """K7's scratch, owned by its caller: the pipeline keeps one for the
    run (``NerfLoamSLAM_torch.insert_scratch``) and hands it to every
    insert. It holds the two election grids (points, corners), filled with
    INT_MAX once and left so by every call (each winner resets its own
    cell), the compacted candidates and their corner cells, and the tile
    states and tickets of the kernel's three scans (zeroed by its first
    pass). It is allocated at its first call on the card and again for a
    larger region, more points or a larger candidate cap, and dropped by
    a call whose launch fails (the next call starts afresh). Calls on one
    stream take turns with it."""

    def __init__(self):
        self.drop()

    def fit(self, dev, total: int, P: int, Pc: int):
        """The kernel's scratch pointers (winner, cwinner, vox_c, cflat,
        scan) for a region of ``total`` cells, P points and a cap of Pc."""
        if self.ptrs is None or dev != self.dev or total > self.total or P > self.P or Pc > self.Pc:
            total, P, Pc = max(total, self.total), max(P, self.P), max(Pc, self.Pc, 1)
            i32 = dict(dtype=torch.int32, device=dev)
            self.grids = torch.full((2 * total,), _INT_MAX, **i32)
            self._bufs = (torch.empty((3 * Pc,), **i32), torch.empty((8 * Pc,), **i32),
                          torch.empty((kernels.lib().nl_insert_scan_words(P, Pc),),
                                      dtype=torch.int64, device=dev))
            self.total, self.P, self.Pc, self.dev = total, P, Pc, dev
            g = self.grids.data_ptr()
            self.ptrs = (g, g + 4 * total, *[t.data_ptr() for t in self._bufs])
        return self.ptrs

    def drop(self):
        self.total = self.P = self.Pc = 0
        self.dev = self.ptrs = self.grids = self._bufs = None


def _check_insert(name, state: MapState, cfg: MapConfig, dev, points_world, valid):
    """What the K7 kernel reads and writes, as it reads it; raise ValueError
    on anything else (nothing is converted)."""
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    total, P = int(np.prod(cfg.grid_dim)), points_world.shape[0]
    kernels.expect(name, dev, torch.float32, points_world=points_world, packed=state.packed)
    kernels.expect(name, dev, torch.bool, valid=valid, is_surface=state.is_surface)
    kernels.expect(name, dev, torch.int32, lat_coords=state.lat_coords,
                   corner_idx=state.corner_idx, grid=state.grid, region_min=state.region_min,
                   active_ids=state.active_ids, active_coords=state.active_coords,
                   grid_active=state.grid_active, num_lat=state.num_lat,
                   n_active=state.n_active, num_cand=state.num_cand)
    if state.embeddings.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: embeddings must be float32 or bfloat16")
    kernels.expect(name, dev, state.embeddings.dtype, embeddings=state.embeddings)
    kernels.expect_shape(name, points_world=(points_world, (P, 3)), valid=(valid, (P,)),
                         lat_coords=(state.lat_coords, (C, 3)), is_surface=(state.is_surface, (C,)),
                         corner_idx=(state.corner_idx, (C, 8)), grid=(state.grid, (total,)),
                         region_min=(state.region_min, (3,)), active_ids=(state.active_ids, (A,)),
                         active_coords=(state.active_coords, (A, 3)),
                         grid_active=(state.grid_active, (total,)),
                         packed=(state.packed, (A, 8 * F)), embeddings=(state.embeddings, (C, F)),
                         num_lat=(state.num_lat, ()), n_active=(state.n_active, ()),
                         num_cand=(state.num_cand, ()))
    if state.packed.data_ptr() % 16 or 8 * P >= 2**31 or 8 * C >= 2**31:
        raise ValueError(f"{name}: packed rows must be 16-byte aligned, 8 P and 8 C < 2^31")
    _pack_check(name, state.embeddings, A, F)


def insert_points(state: MapState, cfg: MapConfig, points_world: torch.Tensor,
                  valid: torch.Tensor, cand_cap: int = 0, append_active: bool = False,
                  scratch: InsertScratch | None = None):
    """K7. Replaces nerfloam_tpu/map/voxel_map.py:311-449 (insert_points):
    the XLA fusion of the two grid elections, the corner allocation, the
    activation and the active-set append.

    In place: the tables and the scalars num_lat, num_cand (and with
    ``append_active`` n_active) of ``state`` are written, and
    ``(state, record)`` comes back: ``undo_insert(state, record)`` puts
    every one back as it was. A caller that needs the old state either
    undoes the insert (the pipeline's overflow replay does) or clones the
    state first. Same semantics and the same tables and record as the twin.

    CPU tensors take the plain twin ``insert_points_plain``; CUDA tensors
    launch csrc/insert.cu four times (elect; candidates with their scan,
    compaction and corner election; the new rows; activation), and with
    ``append_active`` a fifth (the appended packed rows),
    on inputs as the kernel reads them (contiguous f32 points, bool valid
    and surface flags, int32 tables and 0-d scalars, f32 or bf16
    embeddings, 16-byte aligned rows, feat_dim % 4 == 0): nothing is
    converted, anything else raises ValueError. ``scratch``: an
    ``InsertScratch`` kept by the caller (without one, one made for this
    call: two fills of the region's size)."""
    dev = points_world.device
    if dev.type == "cpu":
        return insert_points_plain(state, cfg, points_world, valid, cand_cap, append_active)
    if dev.type != "cuda":
        raise ValueError(f"insert_points: unsupported device {dev}")
    global insert_launches
    name = "insert_points"
    _check_insert(name, state, cfg, dev, points_world, valid)
    P = points_world.shape[0]
    C, A, F = cfg.capacity, acap(cfg), cfg.feat_dim
    Pc = cand_cap if 0 < cand_cap < P else P
    scratch = InsertScratch() if scratch is None else scratch
    ptrs = scratch.fit(dev, int(np.prod(cfg.grid_dim)), P, Pc)
    rec = _new_record(dev, cfg, Pc, append_active)
    emb = state.embeddings
    err = kernels.lib().nl_insert(
        points_world.data_ptr(), valid.data_ptr(), P, cfg.voxel_size, state.region_min.data_ptr(),
        *cfg.grid_dim, Pc, C, A, F, int(append_active), emb.data_ptr(),
        int(emb.dtype == torch.bfloat16), state.lat_coords.data_ptr(),
        state.is_surface.data_ptr(), state.corner_idx.data_ptr(), state.grid.data_ptr(),
        state.active_ids.data_ptr(), state.active_coords.data_ptr(),
        state.grid_active.data_ptr(), state.packed.data_ptr(), state.num_lat.data_ptr(),
        state.n_active.data_ptr(), state.num_cand.data_ptr(), *ptrs, rec.ints.data_ptr(),
        rec.packed.data_ptr(), rec.rows, kernels.stream_ptr(dev))
    if err:
        scratch.drop()  # its election grids may not be reset
        kernels.check(err, name)
    insert_launches += 1
    return state, rec


def undo_insert_plain(state: MapState, rec: InsertRecord) -> MapState:
    """Plain torch twin of ``undo_insert``."""
    h, rows, cands, slots = _record_views(rec)
    num_lat0, n_active0, num_cand0, n_rows, n_act, n_app = h[:6].tolist()
    dev = rows.device
    rows, cands, slots = rows[:n_rows], cands[:n_act].long(), slots[:n_app]
    state.lat_coords[num_lat0:num_lat0 + n_rows] = rows[:, :3]
    state.grid[rows[:, 3].long()] = rows[:, 4]
    state.is_surface[cands[:, 0]] = cands[:, 1].bool()
    state.corner_idx[cands[:, 0]] = cands[:, 2:].to(torch.int32)
    pos = torch.arange(n_active0, n_active0 + n_app, device=dev)
    state.active_ids[pos] = slots[:, 0]
    state.active_coords[pos] = slots[:, 1:4]
    state.grid_active[slots[:, 4].long()] = slots[:, 5]
    state.packed[pos] = rec.packed[:n_app]
    for t, v in ((state.num_lat, num_lat0), (state.n_active, n_active0),
                 (state.num_cand, num_cand0)):
        t.fill_(v)
    return state


def undo_insert(state: MapState, rec: InsertRecord) -> MapState:
    """Put back every table and scalar that the insert which gave ``rec``
    wrote into ``state`` (the same tensors, in place), as they were before
    it. Undoing one record twice changes nothing more. CPU tensors take
    ``undo_insert_plain``; CUDA tensors launch csrc/insert.cu once."""
    dev = rec.ints.device
    if dev.type == "cpu":
        return undo_insert_plain(state, rec)
    if dev.type != "cuda":
        raise ValueError(f"undo_insert: unsupported device {dev}")
    global insert_undo_launches
    kernels.check(kernels.lib().nl_insert_undo(
        rec.ints.data_ptr(), rec.packed.data_ptr(), rec.rows, rec.cands, rec.slots,
        state.packed.shape[1] // 8, state.lat_coords.data_ptr(), state.grid.data_ptr(),
        state.is_surface.data_ptr(), state.corner_idx.data_ptr(), state.active_ids.data_ptr(),
        state.active_coords.data_ptr(), state.grid_active.data_ptr(), state.packed.data_ptr(),
        state.num_lat.data_ptr(), state.n_active.data_ptr(), state.num_cand.data_ptr(),
        kernels.stream_ptr(dev)), "undo_insert")
    insert_undo_launches += 1
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


def surface_voxel_ids(state: MapState) -> torch.Tensor:
    """Rows of the allocated surface voxels, ascending, on the map's device
    (a dynamic shape: one host read)."""
    C = state.is_surface.shape[0]
    surf = state.is_surface & (torch.arange(C, device=state.is_surface.device) < state.num_lat)
    return torch.nonzero(surf).squeeze(1).to(torch.int32)


def surface_snapshot(state: MapState) -> dict:
    """Host export of the surface voxels for meshing and diagnostics (JAX
    voxel_map.py:492-504): numpy rows, lattice coords and corner rows."""
    idx = surface_voxel_ids(state).long()
    return {
        "voxel_ids": idx.cpu().numpy(),
        "coords": state.lat_coords[idx].cpu().numpy(),
        "corner_idx": state.corner_idx[idx].cpu().numpy(),
        "num_lat": int(state.num_lat),
    }


def recenter_refresh(state: MapState, cfg: MapConfig, center_world: torch.Tensor) -> MapState:
    return refresh_active(recenter(state, cfg, center_world), cfg)


def needs_recenter(state: MapState, cfg: MapConfig, center_world: torch.Tensor,
                   margin: float) -> torch.Tensor:
    """() bool on the device: the sensor moved more than ``margin`` meters
    (max-abs over axes) from the current region center."""
    dims = const(tuple(cfg.grid_dim), torch.int32, state.grid.device)
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
                 cand_cap: int = 0, append_active: bool = False,
                 scratch: InsertScratch | None = None):
    """World transform + insert (create_voxels, JAX voxel_map.py:535-575),
    in place as ``insert_points``: returns ``(state, record)``. With
    ``cfg.support_dist > 0`` each measured point also inserts a support
    point that far past the surface: straight down for ground points (cos
    < 0.999), along the ray otherwise; ``support_sym`` adds the mirror
    point on the sensor side. One insert_points pass takes all."""
    world = se3.transform_points(pose6, points_sensor)
    if cfg.support_dist <= 0:
        return insert_points(state, cfg, world, valid, cand_cap, append_active, scratch)
    dirs = points_sensor / (norm3(points_sensor, keepdim=True) + 1e-8)
    wdirs = se3.rotate_dirs(pose6, dirs)
    down = const((0.0, 0.0, -1.0), world.dtype, world.device)
    off = torch.where(points_cos[:, None] < 0.999, down[None, :], wdirs)
    pts = [world, world + off * cfg.support_dist]
    if cfg.support_sym:
        pts.append(world - off * cfg.support_dist)
    return insert_points(state, cfg, torch.cat(pts, 0), torch.cat([valid] * len(pts), 0),
                         cand_cap, append_active, scratch)
