"""Mesh extraction (port of nerfloam_tpu/map/mesher.py): every surface voxel
is sampled on a res^3 lattice spanning the voxel and triangulated by
marching tetrahedra on the device; the host welds duplicate vertices.

Device passes: K10a ``mesh_lattice`` (csrc/mesh.cu) gathers each voxel's 8
corner embeddings and interpolates features and positions on the lattice,
the decoder turns the features into SDF values (``decoder_apply``, a plain
matrix product as in JAX), and K10b triangulates: the mesh path takes its
compact form ``ops.marching.marching_tets_compact``, which writes only the
valid triangles and their count on the device, and copies them to the
host once per chunk (JAX's padded form, ``marching_tets_lattice``, is
``_mesh_chunk``'s). ``clean_mesh`` culls faces far
from any observed point (scipy ``cKDTree``), on the host as in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.models.decoder import PLAIN, DecoderMeta, decoder_apply
from nerfloam_tpu_torch.ops.interp import trilinear_weights
from nerfloam_tpu_torch.ops.keys import COORD_MASK, weld_key_np
from nerfloam_tpu_torch.ops.marching import (
    TetScratch,
    marching_tets_compact,
    marching_tets_lattice,
)

# K10a launches on CUDA tensors (plain integer; chip_smoke.py resets and reads it)
mesh_lattice_launches = 0
_K10A = "mesh_lattice"
# lattice cells per device chunk: the (cells, 12, 3, 3) triangle buffer of a
# chunk stays under 1 GiB
CHUNK_CELLS = 1 << 21


def _lattice_fractions(res: int) -> np.ndarray:
    """(res^3, 3) fractional sample positions in [0, 1]^3, x slowest."""
    u = np.linspace(0.0, 1.0, res)
    xx, yy, zz = np.meshgrid(u, u, u, indexing="ij")
    return np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)


def _cell_corner_table(res: int) -> np.ndarray:
    """((res-1)^3, 8) indices into the res^3 lattice; corner j = x<<2|y<<1|z."""
    n = res - 1
    idx = np.arange(res**3).reshape(res, res, res)
    cells = []
    for x in range(n):
        for y in range(n):
            for z in range(n):
                cells.append([idx[x + ((j >> 2) & 1), y + ((j >> 1) & 1), z + (j & 1)]
                              for j in range(8)])
    return np.asarray(cells, np.int32)


@functools.lru_cache(maxsize=8)
def _lattice_tables(res: int, device):
    """(fr (S, 3), trilinear weights (S, 8), cell table (ncell, 8)) on
    ``device``, uploaded once per resolution."""
    fr = torch.as_tensor(_lattice_fractions(res), device=device)
    cct = torch.as_tensor(_cell_corner_table(res), device=device)
    return fr, trilinear_weights(fr).contiguous(), cct


def mesh_lattice_plain(map_state: vm.MapState, map_cfg: vm.MapConfig, voxel_ids: torch.Tensor,
                       res: int):
    """Plain torch twin of K10a (mesher.py:59-72 without the decoder):
    corner rows through clip(cidx, 0), widened to float32, summed with the
    trilinear weights in corner order, each product and add rounded on its
    own; positions base + fr * vs."""
    safe = torch.clamp(voxel_ids, min=0).long()
    cidx = map_state.corner_idx[safe]                                   # (B, 8)
    embs = map_state.embeddings[torch.clamp(cidx, min=0).long()].float()  # (B, 8, F)
    fr, w, _ = _lattice_tables(res, voxel_ids.device)                    # (S, 3), (S, 8)
    feats = w[None, :, 0, None] * embs[:, None, 0, :]
    for j in range(1, 8):
        feats = feats + w[None, :, j, None] * embs[:, None, j, :]        # (B, S, F)
    vs = map_cfg.voxel_size
    base = map_state.lat_coords[safe].float() * vs                       # voxel min corner
    pos = base[:, None, :] + fr[None] * vs                               # (B, S, 3)
    return feats, pos


def _lattice_inputs(map_state: vm.MapState, map_cfg: vm.MapConfig, voxel_ids: torch.Tensor,
                    res: int):
    """Check K10a's inputs as the kernel reads them (voxel_ids (B,) and the
    (C, 8) corner and (C, 3) coordinate tables int32, the (C, F) embeddings
    f32 or bf16, each contiguous and on one device) and return the device;
    on the card also F in (8, 16, 32), res in (2, 3, 4), B * res^3 * F
    under 2^31 and the embeddings 16-byte aligned."""
    dev = voxel_ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{_K10A}: unsupported device {dev}")
    emb, F = map_state.embeddings, map_cfg.feat_dim
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{_K10A}: embeddings must be float32 or bfloat16; got {emb.dtype}")
    if voxel_ids.dim() != 1:
        raise ValueError(f"{_K10A}: voxel_ids must be (B,); got {tuple(voxel_ids.shape)}")
    cidx, lat = map_state.corner_idx, map_state.lat_coords
    kernels.expect(_K10A, dev, torch.int32, voxel_ids=voxel_ids, corner_idx=cidx, lat_coords=lat)
    kernels.expect(_K10A, dev, emb.dtype, embeddings=emb)
    C = cidx.shape[0]
    kernels.expect_shape(_K10A, corner_idx=(cidx, (C, 8)), lat_coords=(lat, (C, 3)),
                         embeddings=(emb, (emb.shape[0], F)))
    if dev.type == "cuda":
        if F not in (8, 16, 32) or res not in (2, 3, 4):
            raise ValueError(f"{_K10A}: the kernel takes feat_dim 8, 16 or 32 and res 2, 3 or "
                             f"4; got {F} and {res}")
        if voxel_ids.shape[0] * res ** 3 * F >= 2**31:
            raise ValueError(f"{_K10A}: {voxel_ids.shape[0]} voxels x {res ** 3} samples x {F} "
                             "features need 32-bit indices")
        if emb.data_ptr() % 16:
            raise ValueError(f"{_K10A}: embeddings must be 16-byte aligned")
    return dev


def mesh_lattice(map_state: vm.MapState, map_cfg: vm.MapConfig, voxel_ids: torch.Tensor,
                 res: int):
    """K10a. Replaces the XLA fusion of nerfloam_tpu/map/mesher.py:59-72
    (the corner gather, the trilinear einsum and the lattice positions of
    ``_mesh_chunk``).

    voxel_ids (B,) int32 lattice rows of surface voxels (-1 = padding, reads
    row 0) -> (feats (B, res^3, F) float32, pos (B, res^3, 3) float32).
    Inputs are taken as they are (``_lattice_inputs``): anything else
    raises ValueError. CPU tensors take ``mesh_lattice_plain``; CUDA
    tensors launch csrc/mesh.cu once (a group of F / 4 lanes per voxel)."""
    dev = _lattice_inputs(map_state, map_cfg, voxel_ids, res)
    if dev.type == "cpu":
        return mesh_lattice_plain(map_state, map_cfg, voxel_ids, res)
    global mesh_lattice_launches
    emb, F = map_state.embeddings, map_cfg.feat_dim
    fr, w, _ = _lattice_tables(res, dev)
    B, S = voxel_ids.shape[0], fr.shape[0]
    feats = torch.empty((B, S, F), dtype=torch.float32, device=dev)
    pos = torch.empty((B, S, 3), dtype=torch.float32, device=dev)
    kernels.check(kernels.lib().nl_mesh_lattice(
        voxel_ids.data_ptr(), map_state.corner_idx.data_ptr(), emb.data_ptr(),
        int(emb.dtype == torch.bfloat16), map_state.lat_coords.data_ptr(), fr.data_ptr(),
        w.data_ptr(), B, res, F, map_cfg.voxel_size, feats.data_ptr(), pos.data_ptr(),
        kernels.stream_ptr(dev)), _K10A)
    if B:
        mesh_lattice_launches += 1
    return feats, pos


@torch.no_grad()
def _chunk_lattice(map_state: vm.MapState, map_cfg: vm.MapConfig, decoder_params,
                   voxel_ids: torch.Tensor, res: int, compute_dtype: str = "float32",
                   dec_meta: DecoderMeta = PLAIN):
    """K10b's inputs for B surface voxels (pad: -1): K10a's lattice, the
    decoder's sdf on it, the cell table and the ids."""
    feats, pos = mesh_lattice(map_state, map_cfg, voxel_ids, res)
    sdf = decoder_apply(decoder_params, feats, getattr(torch, compute_dtype),
                        dec_meta)[..., 0]  # (B, S)
    return sdf, pos, _lattice_tables(res, voxel_ids.device)[2], voxel_ids


def _mesh_chunk(map_state: vm.MapState, map_cfg: vm.MapConfig, decoder_params,
                voxel_ids: torch.Tensor, res: int, compute_dtype: str = "float32",
                dec_meta: DecoderMeta = PLAIN):
    """Triangles of B surface voxels (pad: -1) in JAX's padded form: K10a,
    the decoder, K10b. Returns (tris (B * (res-1)^3, 12, 3, 3), valid (..,
    12))."""
    return marching_tets_lattice(*_chunk_lattice(map_state, map_cfg, decoder_params, voxel_ids,
                                                 res, compute_dtype, dec_meta))


def weld(tris: np.ndarray):
    """Weld duplicate vertices of (T, 3, 3) triangles: quantize relative to
    the mesh min corner and dedup on one int64 lattice key. Duplicate
    vertices across cells and chunks are bitwise equal (same corner values,
    same arithmetic), so any quantum well under voxel_size welds exactly;
    it only coarsens past 1e-4 m when the scene outgrows the 21-bit key
    range. Degenerate faces are dropped. Returns (verts (V, 3), faces (F, 3))."""
    flat = tris.reshape(-1, 3)
    vmin = flat.min(axis=0)
    span = float((flat.max(axis=0) - vmin).max())
    quantum = max(1e-4, span / (COORD_MASK - 1))
    keys = np.round((flat - vmin) / quantum).astype(np.int64)
    _, first_idx, inverse = np.unique(weld_key_np(keys), return_index=True, return_inverse=True)
    verts = flat[first_idx]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good]


def extract_triangles(map_state: vm.MapState, map_cfg: vm.MapConfig, decoder_params,
                      res: int = 2, compute_dtype: str = "float32",
                      chunk_cells: int = CHUNK_CELLS,
                      scratch: TetScratch | None = None,
                      dec_meta: DecoderMeta = PLAIN) -> np.ndarray:
    """The map's valid triangles (T, 3, 3) on the host, in ascending
    (voxel row, cell, tetrahedron, slot) order: the device half of
    :func:`extract_mesh`. Per chunk, K10b's compact form (through
    ``scratch``, a TetScratch; None: one made for this call) writes the
    valid triangles and their count T on the device; T is read once and
    ``tris[:T]`` copied to the host."""
    ids = vm.surface_voxel_ids(map_state)
    ncell = (res - 1) ** 3
    chunk = max(1, chunk_cells // max(ncell, 1))
    scratch = TetScratch() if scratch is None else scratch
    parts = []
    for i in range(0, ids.shape[0], chunk):
        tris, count = marching_tets_compact(
            *_chunk_lattice(map_state, map_cfg, decoder_params, ids[i:i + chunk], res,
                            compute_dtype, dec_meta), scratch=scratch)
        parts.append(tris[:int(count)].cpu().numpy())
    if not parts:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(parts, 0)


def extract_mesh(map_state: vm.MapState, map_cfg: vm.MapConfig, decoder_params, res: int = 2,
                 compute_dtype: str = "float32", chunk_cells: int = CHUNK_CELLS,
                 scratch: TetScratch | None = None, dec_meta: DecoderMeta = PLAIN):
    """Triangle mesh of the whole map. Returns (vertices (V, 3) float32,
    faces (F, 3) int32). ``res`` matches the reference's mesh_res (2 in all
    LiDAR configs: corner-only sampling, one cell per voxel)."""
    tris = extract_triangles(map_state, map_cfg, decoder_params, res, compute_dtype, chunk_cells,
                             scratch, dec_meta)
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return weld(tris)


def downsample_points(points: np.ndarray, voxel: float = 0.05) -> np.ndarray:
    """Voxel-grid downsample (one representative point per cell), which
    bounds the KD-tree size in :func:`clean_mesh`."""
    if len(points) == 0:
        return points
    pmin = points.min(axis=0)
    span = float((points.max(axis=0) - pmin).max())
    voxel = max(voxel, span / (COORD_MASK - 1))  # keep keys in 21 bits/axis
    cells = np.floor((points - pmin) / voxel).astype(np.int64)
    _, first = np.unique(weld_key_np(cells), return_index=True)
    return points[first]


def clean_mesh(verts: np.ndarray, faces: np.ndarray, observed_points: np.ndarray,
               radius: float) -> np.ndarray:
    """SHINE-protocol mesh culling: keep only faces with at least one
    vertex within ``radius`` of an observed point. Returns the filtered
    faces (vertices stay, so face indices stay valid)."""
    if len(faces) == 0 or len(observed_points) == 0:
        return faces
    from scipy.spatial import cKDTree

    n_near = cKDTree(observed_points).query_ball_point(verts, radius, workers=-1,
                                                       return_length=True)
    point_mask = np.asarray(n_near) > 0
    return faces[point_mask[faces.reshape(-1)].reshape(-1, 3).any(-1)]
