"""Lattice-key packing and the Morton (Z-order) codec (port of
nerfloam_tpu/ops/keys.py).

Three signed lattice coordinates of 21 bits each: ``COORD_OFFSET`` moves
them to [0, 2^21). ``pack`` / ``unpack`` put them into a pair of int32
words (hi, lo), ``morton_encode`` / ``morton_decode`` interleave them as
the reference octree's ``compute_morton`` does (x at bits 3i+2, y 3i+1, z
3i of a 63-bit code split into (hi, lo)), and ``lexsort_keys`` orders
(hi, lo) pairs so that equal keys sit side by side. They are plain torch
int32 bit arithmetic, as JAX's are jnp's, and lie on no path of the
pipeline (its insert elects voxels through the region grid). The host
form ``weld_key_np`` packs the three coordinates into one int64 for
welding mesh vertices and voxel-grid downsampling with ``np.unique`` on a
1-D array.
"""

from __future__ import annotations

import numpy as np
import torch

COORD_BITS = 21
COORD_OFFSET = 1 << (COORD_BITS - 1)  # 2^20: signed coords -> non-negative
COORD_MASK = (1 << COORD_BITS) - 1

# the sentinel key: it sorts after every valid key as (hi, lo), hi of a
# valid key being below 2^31 - 1
INVALID_HI = 0x7FFFFFFF
INVALID_LO = 0x7FFFFFFF


def pack(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed lattice coords (..., 3) -> (hi, lo) int32 words:
    hi = x[20:0] << 10 | y[20:11] (31 bits, never negative),
    lo = y[10:0] << 21 | z[20:0] (32 bits; the sign bit may be set)."""
    c = coords.to(torch.int32) + COORD_OFFSET
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    return (x << 10) | (y >> 11), ((y & 0x7FF) << 21) | z


def unpack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack``: signed lattice coords (..., 3) int32."""
    hi, lo = hi.to(torch.int32), lo.to(torch.int32)
    x = (hi >> 10) & COORD_MASK
    y = (((hi & 0x3FF) << 11) | ((lo >> 21) & 0x7FF)) & COORD_MASK
    z = lo & COORD_MASK
    return torch.stack([x, y, z], -1) - COORD_OFFSET


def _part1by2_21(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The low 21 bits of ``v`` spread 3 positions apart: bit i to bit 3i
    of a 63-bit word, returned as (hi: bits 32-62, lo: bits 0-31)."""
    v = v.to(torch.int32) & COORD_MASK
    lo = torch.zeros_like(v)
    hi = torch.zeros_like(v)
    for i in range(COORD_BITS):
        bit = (v >> i) & 1
        g = 3 * i
        if g < 32:
            lo = lo | (bit << g)
        else:
            hi = hi | (bit << (g - 32))
    return hi, lo


def morton_encode(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Z-order code of signed coords (..., 3) as a (hi, lo) int32 pair."""
    c = coords.to(torch.int32) + COORD_OFFSET
    xh, xl = _part1by2_21(c[..., 0])
    yh, yl = _part1by2_21(c[..., 1])
    zh, zl = _part1by2_21(c[..., 2])

    def shl64(hi, lo, s):  # (hi, lo) << s for s in {1, 2}
        return (hi << s) | ((lo >> (32 - s)) & ((1 << s) - 1)), lo << s

    xh, xl = shl64(xh, xl, 2)
    yh, yl = shl64(yh, yl, 1)
    return xh | yh | zh, xl | yl | zl


def morton_decode(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of ``morton_encode``."""
    hi, lo = hi.to(torch.int32), lo.to(torch.int32)
    out = []
    for axis_shift in (2, 1, 0):  # x, y, z
        v = torch.zeros_like(hi)
        for i in range(COORD_BITS):
            g = 3 * i + axis_shift
            bit = ((lo >> g) & 1) if g < 32 else ((hi >> (g - 32)) & 1)
            v = v | (bit << i)
        out.append(v - COORD_OFFSET)
    return torch.stack(out, -1)


def lexsort_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A permutation sorting (hi, lo) pairs lexicographically (hi, then
    signed lo): two stable argsorts, lo then hi. Equal keys end up side by
    side; the INVALID sentinel sorts last."""
    order1 = torch.argsort(lo, stable=True)
    order2 = torch.argsort(hi[order1], stable=True)
    return order1[order2]


def weld_key_np(coords: np.ndarray) -> np.ndarray:
    """One int64 key per row of ``coords`` (..., 3), non-negative integers
    below 2^21 per component."""
    c = coords.astype(np.int64)
    return (c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS) | c[..., 2]
