"""Gumbel-top-k ray subsampling (port of nerfloam_tpu/ops/sampling.py).

A draw is the generator's uniform draw ``u`` (torch.rand: the port's Philox
stream), its keys ``(valid ? 0 : -1e9) - log(-log(max(u, tiny)))`` and
torch.topk of them. On the card the keys are one launch of
csrc/draw_keys.cu (``draw_keys``, counted by ``draw_keys_launches``),
torch.equal to the chain of seven eager operations that a CPU tensor takes
(``draw_keys_plain``; on the CPU a draw takes its noise from ``gumbel``,
which the parity tests replace to feed the same numpy draw to both
frameworks). The trackers and BA take the indices alone (``draw_indices``)
and gather the picks with their setup in one launch
(``tracking.ray_draw``); ``sample_ray_indices`` also returns the picks'
valid flags, and takes a given Gumbel draw."""

from __future__ import annotations

import torch

from nerfloam_tpu_torch import kernels

draw_keys_launches = 0
_TINY = torch.finfo(torch.float32).tiny


def _noise(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise -log(-log(u)), u clamped to the smallest normal float."""
    return -torch.log(-torch.log(torch.clamp(u, min=_TINY)))


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U uniform in (0, 1)."""
    return _noise(torch.rand(shape, generator=generator, device=device))


def draw_keys_plain(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The keys of a draw by the chain of ops: the mask's logits plus the
    Gumbel noise of ``u``."""
    return torch.where(valid, 0.0, -1e9) + _noise(u)


def draw_keys(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The keys of a Gumbel top-k draw from the uniform draw ``u`` (...)
    f32 and ``valid`` (...) bool. A CPU tensor takes ``draw_keys_plain``; a
    CUDA tensor one launch of csrc/draw_keys.cu, torch.equal to it, and
    both must be contiguous on one card (else ValueError)."""
    name, dev = "draw_keys", u.device
    if dev.type == "cpu":
        return draw_keys_plain(u, valid)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    kernels.expect(name, dev, torch.float32, u=u)
    kernels.expect(name, dev, torch.bool, valid=valid)
    kernels.expect_shape(name, valid=(valid, tuple(u.shape)))
    global draw_keys_launches
    keys = torch.empty_like(u)
    if u.numel():
        kernels.check(kernels.lib().nl_draw_keys(u.data_ptr(), valid.data_ptr(), u.numel(),
                                                 keys.data_ptr(), kernels.stream_ptr(dev)), name)
        draw_keys_launches += 1
    return keys


def draw_indices(valid: torch.Tensor, n_rays: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``n_rays`` indices drawn uniformly without replacement from the valid
    slots of ``valid`` (..., P) bool: (..., n_rays) int64, torch.topk's
    order. A pick lands on an invalid slot only where fewer than n_rays are
    valid. On the CPU the keys are the mask's logits plus ``gumbel``'s
    noise (``draw_keys_plain`` of the same uniforms)."""
    if valid.device.type == "cpu":
        keys = torch.where(valid, 0.0, -1e9) + gumbel(valid.shape, generator, valid.device)
    else:
        keys = draw_keys(torch.rand(valid.shape, generator=generator, device=valid.device), valid)
    return torch.topk(keys, n_rays, dim=-1)[1]


def sample_ray_indices(valid: torch.Tensor, n_rays: int,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None):
    """Pick ``n_rays`` indices uniformly without replacement from the valid
    slots of ``valid`` (..., P). ``noise``: optional Gumbel draw of
    valid's shape (tests feed the same numpy draw to both frameworks).
    Returns (idx (..., n_rays) int64, picked_valid (..., n_rays) bool)."""
    if noise is None:
        idx = draw_indices(valid, n_rays, generator)
    else:
        _, idx = torch.topk(torch.where(valid, 0.0, -1e9) + noise, n_rays, dim=-1)
    return idx, torch.gather(valid, -1, idx)
