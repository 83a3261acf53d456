"""Host-side integer keys (port of the numpy part of
nerfloam_tpu/ops/keys.py, whose module imports jax): three lattice
coordinates of 21 bits each packed into one int64, for welding mesh
vertices and voxel-grid downsampling with ``np.unique`` on a 1-D array."""

from __future__ import annotations

import numpy as np

COORD_BITS = 21
COORD_MASK = (1 << COORD_BITS) - 1


def weld_key_np(coords: np.ndarray) -> np.ndarray:
    """One int64 key per row of ``coords`` (..., 3), non-negative integers
    below 2^21 per component."""
    c = coords.astype(np.int64)
    return (c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS) | c[..., 2]
