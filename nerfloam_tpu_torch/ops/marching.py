"""Marching tetrahedra on the device (port of nerfloam_tpu/ops/marching.py).

Each lattice cell is split into 6 Kuhn tetrahedra sharing the main diagonal
(corner 0 -> corner 7); the split is translation-consistent, so the surface
is watertight across cells and across voxels. Each tetrahedron has 16 sign
cases emitting at most 2 triangles whose vertices are linear zero crossings
on its edges. The (cells, 12) triangle buffer is compacted with its mask by
the caller.

K10b ``marching_tets_lattice`` (csrc/mesh.cu) fuses the cell gather through
the cell-corner table, the tetrahedra and the padding mask of
nerfloam_tpu/map/mesher.py:74-82; ``marching_tets_cells`` is the JAX
signature (one cell per row), the same kernel with an identity table. The
plain twins run on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfloam_tpu_torch import kernels

# K10b launches on CUDA tensors (plain integer; chip_smoke.py resets and reads it)
marching_tets_launches = 0

# Cube corners indexed j = x<<2 | y<<1 | z (ops.interp.CORNER_OFFSETS).
# Kuhn subdivision: per axis permutation p, tet = {0, e_p1, e_p1+e_p2, 7}.
TET_CORNERS = np.array(
    [[0, 4, 6, 7], [0, 4, 5, 7], [0, 2, 6, 7], [0, 2, 3, 7], [0, 1, 5, 7], [0, 1, 3, 7]],
    dtype=np.int32)

# Tet edges: pairs of local tet-corner indices.
EDGE_PAIRS = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32)

# For each of 16 sign cases (bit i set <=> corner i inside, sdf < 0): up to
# two triangles as triples of edge ids; -1 = unused slot.
_T = -np.ones((16, 2, 3), dtype=np.int32)
_T[1, 0] = (0, 1, 2)                       # v0 inside
_T[2, 0] = (0, 3, 4)                       # v1
_T[3] = ((1, 2, 4), (1, 4, 3))             # v0 v1
_T[4, 0] = (1, 5, 3)                       # v2
_T[5] = ((0, 2, 5), (0, 5, 3))             # v0 v2
_T[6] = ((0, 4, 5), (0, 5, 1))             # v1 v2
_T[7, 0] = (2, 4, 5)                       # v0 v1 v2
_T[8, 0] = (2, 5, 4)                       # v3
_T[9] = ((0, 1, 5), (0, 5, 4))             # v0 v3
_T[10] = ((0, 3, 5), (0, 5, 2))            # v1 v3
_T[11, 0] = (1, 3, 5)                      # v0 v1 v3
_T[12] = ((1, 4, 2), (1, 3, 4))            # v2 v3
_T[13, 0] = (0, 4, 3)                      # v0 v2 v3
_T[14, 0] = (0, 2, 1)                      # v1 v2 v3
TRI_TABLE = _T


def marching_tets_cells_plain(cell_pos: torch.Tensor, cell_val: torch.Tensor):
    """Plain torch twin of K10b on gathered cells (marching.py:63-106).

    cell_pos (N, 8, 3) world positions of the cube corners, cell_val (N, 8)
    their SDF values -> (tris (N, 12, 3, 3), valid (N, 12)): up to 6 tets x
    2 triangles per cell. Every step is its own rounded operation, in the
    kernel's order."""
    dev = cell_pos.device
    tc = torch.as_tensor(TET_CORNERS, device=dev).long()      # (6, 4)
    ep = torch.as_tensor(EDGE_PAIRS, device=dev).long()       # (6, 2)
    table = torch.as_tensor(TRI_TABLE, device=dev).long()     # (16, 2, 3)
    vals = cell_val[:, tc]                                    # (N, 6, 4)
    pos = cell_pos[:, tc]                                     # (N, 6, 4, 3)
    inside = (vals < 0).long()
    case = inside[..., 0] + (inside[..., 1] << 1) + (inside[..., 2] << 2) + (inside[..., 3] << 3)
    va, vb = vals[..., ep[:, 0]], vals[..., ep[:, 1]]         # (N, 6, 6)
    pa, pb = pos[:, :, ep[:, 0]], pos[:, :, ep[:, 1]]         # (N, 6, 6, 3)
    denom = va - vb
    t = va / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    t = torch.clamp(t, 0.0, 1.0)
    edge_v = pa + t[..., None] * (pb - pa)                    # (N, 6, 6, 3)
    tri_edges = table[case]                                   # (N, 6, 2, 3)
    safe = torch.clamp(tri_edges, min=0)
    tris = torch.gather(edge_v[:, :, None].expand(-1, -1, 2, -1, -1), 3,
                        safe[..., None].expand(-1, -1, -1, -1, 3))  # (N, 6, 2, 3, 3)
    valid = tri_edges[..., 0] >= 0
    N = cell_pos.shape[0]
    return tris.reshape(N, 12, 3, 3), valid.reshape(N, 12)


def marching_tets_lattice_plain(sdf, pos, cct, voxel_ids=None):
    """Plain twin of K10b: gather each voxel's cells from its lattice
    (mesher.py:74-82), triangulate, and mask the padding voxels (id -1)."""
    B, ncell = sdf.shape[0], cct.shape[0]
    cc = cct.long()
    tris, valid = marching_tets_cells_plain(pos[:, cc].reshape(B * ncell, 8, 3),
                                            sdf[:, cc].reshape(B * ncell, 8))
    if voxel_ids is not None:
        valid = valid & (voxel_ids.repeat_interleave(ncell)[:, None] >= 0)
    return tris, valid


def marching_tets_lattice(sdf: torch.Tensor, pos: torch.Tensor, cct: torch.Tensor,
                          voxel_ids: torch.Tensor | None = None):
    """K10b. Replaces the XLA fusion of nerfloam_tpu/ops/marching.py:63-106
    with the cell gather and padding mask of map/mesher.py:74-82.

    sdf (B, S) and pos (B, S, 3) on each voxel's res^3 lattice, cct
    (ncell, 8) int32 lattice indices of each cell's corners, voxel_ids (B,)
    int32 (-1 = padding) or None -> (tris (B * ncell, 12, 3, 3) float32,
    valid (B * ncell, 12) bool). CPU tensors take the plain twin; CUDA
    tensors launch csrc/mesh.cu (one thread per cell and tetrahedron)."""
    dev = sdf.device
    if dev.type == "cpu":
        return marching_tets_lattice_plain(sdf, pos, cct, voxel_ids)
    if dev.type != "cuda":
        raise ValueError(f"marching_tets_lattice: unsupported device {dev}")
    global marching_tets_launches
    B, S = sdf.shape
    ncell = cct.shape[0]
    if pos.shape != (B, S, 3) or cct.shape[1:] != (8,):
        raise ValueError("marching_tets_lattice: pos must be (B, S, 3) and cct (ncell, 8)")
    sdf, pos = sdf.float().contiguous(), pos.float().contiguous()
    cct = cct.to(torch.int32).contiguous()
    ids = None if voxel_ids is None else voxel_ids.to(torch.int32).contiguous()
    if any(t.device != dev for t in (pos, cct) + (() if ids is None else (ids,))):
        raise ValueError("marching_tets_lattice: all inputs must be on one device")
    tris = torch.empty((B * ncell, 12, 3, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((B * ncell, 12), dtype=torch.bool, device=dev)
    kernels.check(kernels.lib().nl_marching_tets(
        sdf.data_ptr(), pos.data_ptr(), cct.data_ptr(), None if ids is None else ids.data_ptr(),
        B, S, ncell, tris.data_ptr(), valid.data_ptr(), kernels.stream_ptr(dev)), "marching_tets")
    marching_tets_launches += 1
    return tris, valid


def marching_tets_cells(cell_pos: torch.Tensor, cell_val: torch.Tensor):
    """Triangles for N gathered cells (the JAX signature): K10b with one
    cell per row and the identity cell table."""
    cct = torch.arange(8, dtype=torch.int32, device=cell_val.device)[None]
    return marching_tets_lattice(cell_val, cell_pos, cct)
