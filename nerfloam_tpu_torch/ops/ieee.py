"""Arithmetic rounded as the JAX package rounds it on the CPU, on both
devices: divisions by (and of) a Python number, and the length of
3-vectors and of their (x, y) part.

- ``div(x, s)`` / ``rdiv(s, x)``: one IEEE division. torch turns a
  division by a Python scalar into a multiply by its reciprocal on CUDA,
  and ``s / x`` into ``x.reciprocal() * s`` on both devices (two
  roundings); a same-device 0-d tensor operand keeps one rounding
  (``__fdiv_rn`` on the card). The 0-d constants are kept per (value,
  dtype, device), so a division adds no fill launch.
- ``norm3(x)``: ``jnp.linalg.norm(x, axis=-1)`` of (..., 3) f32 vectors.
  XLA's CPU backend contracts the sum of squares into fused multiply-adds
  in index order, ``sqrt(fma(z, z, fma(y, y, x * x)))`` (held bit for bit
  on 65,536 rows against ``jnp.linalg.norm``: the three-products-and-two-
  adds form differs on ~11% of them); torch's CUDA norm reduces in another
  order (9,467 of 65,536 rows differ). CPU tensors take ``norm3_plain``,
  that chain in float64 with each fused operation rounded once to f32;
  CUDA tensors one launch of csrc/norm3.cu (``__fmaf_rn``, ``__fsqrt_rn``),
  which replaces the XLA reduce fusion of ``jnp.linalg.norm`` (no Pallas
  kernel; it keeps a frame's norms at one launch each instead of the five
  eager ops of the plain chain).
- ``sqrt_rn(x)``: the correctly rounded square root (torch's vectorised
  CPU sqrt is not; CUDA's is); ``fma_f32(a, b, c)``: a fused multiply-add
  of f32 tensors, emulated exactly in float64 on either device.
- ``norm2_plain(x)``: ``jnp.linalg.norm(x[..., :2], axis=-1)``, the same
  chain with z = 0, ``sqrt(fma(y, y, x * x))`` (the scan-to-scan range
  image's horizontal range; ``sqrt(x * x + y * y)`` differs on ~9% of
  rows).

csrc/ieee.cuh holds the same chains for the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfloam_tpu_torch import kernels

_CONSTS: dict = {}
norm3_launches = 0


def const(s, dtype, device) -> torch.Tensor:
    """The tensor ``s`` of ``dtype`` on ``device``, made once and never
    written: a number gives a 0-d tensor (a fill, no upload), a tuple (of
    tuples) a vector (matrix). A number or a host array put into a frame's
    work on the card is an upload, which waits for the work queued there."""
    key = (s if isinstance(s, tuple) else float(s), dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = (torch.tensor(s, dtype=dtype, device=device) if isinstance(s, tuple)
                            else torch.full((), s, dtype=dtype, device=device))
    return t


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as IEEE division, as JAX divides an array by a Python
    number (a floor of x / voxel_size, the series terms of se3)."""
    return x / const(s, x.dtype, x.device)


def rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """s / x rounded as IEEE division, as JAX divides a Python number by
    an array (one rounding, not ``x.reciprocal() * s``)."""
    return const(s, x.dtype, x.device) / x


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """sqrt rounded once, as XLA's: CUDA's sqrtf is, torch's vectorised CPU
    sqrt is not (an ulp off on ~0.7% of inputs), so the CPU takes numpy's
    (the IEEE instruction) for an f32 tensor that needs no gradient, and
    else the double root rounded to the input's dtype (exact for f32)."""
    if x.is_cuda:
        return torch.sqrt(x)
    if x.dtype is torch.float32 and not (x.requires_grad and torch.is_grad_enabled()):
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
    return torch.sqrt(x.double()).to(x.dtype)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of f32 tensors rounded once to f32, as a fused
    multiply-add: a * b is exact in float64; the float64 sum is rounded to
    odd (an inexact sum takes the neighbour whose last bit is 1), which
    the rounding to f32 then leaves correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly (two-sum)
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.float()


def norm3_plain(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """|x| over the last axis of (..., 3) f32 vectors in XLA's CPU order:
    sqrt(fma(z, z, fma(y, y, x * x))), each step rounded once to f32
    (torch's vectorised CPU sqrt is not correctly rounded: float64)."""
    a, b, c = x[..., 0], x[..., 1], x[..., 2]
    s = fma_f32(c, c, fma_f32(b, b, a * a))
    n = torch.sqrt(s.double()).float()
    return n[..., None] if keepdim else n


def norm2_plain(x: torch.Tensor) -> torch.Tensor:
    """|(x, y)| of (..., >= 2) f32 vectors in XLA's CPU order:
    sqrt(fma(y, y, x * x)), each step rounded once to f32."""
    a, b = x[..., 0], x[..., 1]
    return torch.sqrt(fma_f32(b, b, a * a).double()).float()


def norm3(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1[, keepdims])`` of (..., 3) f32
    vectors, bit for bit on both devices. CPU tensors take
    ``norm3_plain``; a CUDA tensor must be contiguous f32 with a last axis
    of 3 and need no gradient, or ValueError: one launch of csrc/norm3.cu
    (none for an empty input). The usual call on the card is checked in one
    expression, with the kernel's entry point kept after its first use:
    the wrapper's host time, not the kernel's, is what a call costs."""
    global norm3_launches, _norm3_launch
    index, shape = x.get_device(), x.shape
    if not (index >= 0 and x.dtype is _F32 and shape and shape[-1] == 3 and x.is_contiguous()
            and not (x.requires_grad and torch.is_grad_enabled())):
        _norm3_check(x)
        if x.device.type == "cpu":
            return norm3_plain(x, keepdim)
    n = x.numel() // 3
    out = x.new_empty(n)  # a length, not a torch.Size: the cheaper call
    if n:
        if _norm3_launch is None:
            _norm3_launch = kernels.lib().nl_norm3
        err = _norm3_launch(x.data_ptr(), n, out.data_ptr(), kernels.raw_stream(index))
        if err:
            kernels.check(err, "norm3")
        norm3_launches += 1
    return out if len(shape) == 2 and not keepdim else out.view(
        shape[:-1] + (1,) if keepdim else shape[:-1])

_F32 = torch.float32
_norm3_launch = None  # csrc/norm3.cu's entry point, once the library is loaded


def _norm3_check(x: torch.Tensor) -> None:
    """Raise ValueError on what norm3's kernel cannot take (CPU tensors
    pass: they take the plain form)."""
    name = "norm3"
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    kernels.expect(name, x.device, torch.float32, x=x)
    if x.dim() == 0 or x.shape[-1] != 3:
        raise ValueError(f"{name}: x must be (..., 3); got {tuple(x.shape)}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: no backward; pass a tensor that needs no gradient")
