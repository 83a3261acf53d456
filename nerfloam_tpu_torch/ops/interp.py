"""Trilinear interpolation of voxel-corner embeddings (port of
nerfloam_tpu/ops/interp.py). Corner j sits at offset
((j >> 2) & 1, (j >> 1) & 1, j & 1): x slowest, z fastest."""

from __future__ import annotations

import numpy as np
import torch

from nerfloam_tpu_torch.ops.ieee import div

# (8, 3) corner offsets in the reference corner order.
CORNER_OFFSETS = np.array([[(j >> 2) & 1, (j >> 1) & 1, j & 1] for j in range(8)], dtype=np.int32)


def trilinear_weights(p: torch.Tensor) -> torch.Tensor:
    """Weights for fractional position p (..., 3) in [0,1]^3 -> (..., 8):
    w_j = prod_axis (p q_j + (1-p)(1-q_j)), multiplied x, y, z in turn
    (XLA's reduction order, and the kernels')."""
    q = torch.as_tensor(CORNER_OFFSETS, dtype=p.dtype, device=p.device)
    pq = p[..., None, :] * q + (1.0 - p[..., None, :]) * (1.0 - q)
    fx, fy, fz = pq.unbind(-1)  # one backward (a stack) where indexing takes three
    return (fx * fy) * fz


def interp_corner_features(
    sample_xyz: torch.Tensor,
    voxel_center: torch.Tensor,
    corner_feats: torch.Tensor,
    voxel_size: float,
) -> torch.Tensor:
    """Interpolate (..., 8, F) corner features at world points (..., 3);
    p = (x - center)/voxel_size + 0.5 lies in [0,1]^3 inside the voxel
    (one IEEE division, as JAX's). The eight weighted rows are added in
    corner order, each product and sum rounded on its own: XLA's CPU
    reduction and the kernels' order (``torch.sum`` adds in another)."""
    p = div(sample_xyz - voxel_center, voxel_size) + 0.5
    w = trilinear_weights(p)
    wf = (w[..., None] * corner_feats.to(w.dtype)).unbind(-2)  # one backward, a stack
    out = wf[0]
    for j in range(1, 8):
        out = out + wf[j]
    return out
