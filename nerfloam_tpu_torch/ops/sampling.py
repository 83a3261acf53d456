"""Gumbel-top-k ray subsampling (port of nerfloam_tpu/ops/sampling.py)."""

from __future__ import annotations

import torch


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_ray_indices(valid: torch.Tensor, n_rays: int,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None):
    """Pick ``n_rays`` indices uniformly without replacement from the valid
    slots of ``valid`` (..., P). ``noise``: optional Gumbel draw of
    valid's shape (tests feed the same numpy draw to both frameworks).
    Returns (idx (..., n_rays) int64, picked_valid (..., n_rays) bool)."""
    if noise is None:
        noise = gumbel(valid.shape, generator, valid.device)
    logp = torch.where(valid, 0.0, -1e9)
    _, idx = torch.topk(logp + noise, n_rays, dim=-1)
    return idx, torch.gather(valid, -1, idx)
