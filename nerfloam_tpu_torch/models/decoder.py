"""Shared SDF decoder MLP (port of nerfloam_tpu/models/decoder.py).

Linear(in -> width) + ReLU, (depth - 1) hidden Linear(width -> width) +
ReLU, Linear(width -> 1). Every shipped config runs 16 -> 256 -> 256 -> 1
with ``embedder=none`` and no skips; the reference's variants
(``decoder_specs.skips``, ``embedder`` and ``multires``, lidar.py:6-131)
are a ``DecoderMeta`` kept out of the parameters: a positional embedding
of the input (``nerf``: the input, then sin and cos at 2**k, k <
multires; ``gaussian``: sin(x @ B), B (in_dim, 93) drawn N(0, 1) x 25)
computed in float32 before the compute_dtype cast, and after each hidden
layer i in ``skips`` the embedded input concatenated before its output.
Parameters are a plain dict {"w": [...], "b": [...]} of tensors with the
JAX layout, ``w`` of shape (d_in, d_out), plus ``"gaussian_B"`` with the
gaussian embedder (trained with the other leaves, as JAX's optax step
trains every leaf of the decoder pytree); ``decoder_leaves`` lists them
in a fixed order for BA's Adam.

``compute_dtype=bfloat16`` reproduces JAX's ``dot(bf16, bf16,
preferred_element_type=f32)``: both operands are rounded to bf16 and the
product is taken in float32. A bf16 matmul in torch on CUDA returns a bf16
output (its f32 accumulator is rounded once more), which would cost about
three significant digits on every sdf value. Multiplying the bf16-rounded
operands in float32 instead is exact per product and accumulates in f32,
so the port's tolerance against JAX stays the float32 one (1e-5 on sdf);
the price is that the matmuls run at the card's float32 rate, not its bf16
tensor-core rate. Autograd rounds the cotangents at the same two casts as
JAX's transpose rules. The matmuls stay ``torch.matmul``: JAX leaves them
(and the gaussian embedder's (., 16) x (16, 93) product, in float32, TF32
off) to XLA outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DecoderMeta(NamedTuple):
    """The decoder's architecture beyond its tensors (JAX's DecoderMeta)."""

    skips: tuple = ()
    embedder: str = "none"
    multires: int = 0


PLAIN = DecoderMeta()


def positional_embedding_dim(in_dim: int, embedder: str, multires: int) -> int:
    if embedder == "none":
        return in_dim
    if embedder == "nerf":
        return in_dim * (2 * multires + 1)
    if embedder == "gaussian":
        return 93  # the reference's mapping size (lidar.py:16)
    raise ValueError(f"unknown positional embedder {embedder!r}")


def apply_positional_embedding(x: torch.Tensor, embedder: str, multires: int,
                               gaussian_B: torch.Tensor | None = None) -> torch.Tensor:
    """NeRF sin/cos or Gaussian Fourier embedding of (..., D) (lidar.py:6-68)."""
    if embedder == "none":
        return x
    if embedder == "nerf":
        freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires, dtype=x.dtype,
                                      device=x.device)
        xf = x[..., None, :] * freqs[:, None]  # (..., multires, D)
        enc = torch.cat([torch.sin(xf), torch.cos(xf)], -1).reshape(*x.shape[:-1], -1)
        return torch.cat([x, enc], -1)
    if embedder == "gaussian":
        return torch.sin(torch.matmul(x, gaussian_B))
    raise ValueError(f"unknown positional embedder {embedder!r}")


def init_decoder(depth=2, width=256, in_dim=16, skips=(), embedder="none",
                 multires=0, generator: torch.Generator | None = None, device="cuda"):
    """Decoder params with torch.nn.Linear's default init, U(+-1/sqrt(fan_in));
    the layer widths of JAX's init_decoder (a skip widens the next layer's
    input by the embedded input)."""
    emb_dim = positional_embedding_dim(in_dim, embedder, multires)
    d_ins = [emb_dim] + [width + emb_dim if i in tuple(skips) else width
                         for i in range(depth - 1)] + [width]
    d_outs = [width] * depth + [1]
    params = {"w": [], "b": []}
    for d_in, d_out in zip(d_ins, d_outs):
        bound = 1.0 / np.sqrt(d_in)
        for name, shape in (("w", (d_in, d_out)), ("b", (d_out,))):
            u = torch.rand(shape, generator=generator, device=device)
            params[name].append((u * 2.0 - 1.0) * bound)
    if embedder == "gaussian":
        params["gaussian_B"] = torch.randn((in_dim, 93), generator=generator,
                                           device=device) * 25.0
    return params


def decoder_leaves(params) -> list:
    """Every tensor of the decoder, in a fixed order: w, b, gaussian_B."""
    return [*params["w"], *params["b"], *([params["gaussian_B"]] if "gaussian_B" in params
                                         else [])]


def map_decoder(params, fn):
    """The decoder dict with ``fn`` applied to each tensor."""
    out = {k: [fn(p) for p in params[k]] for k in ("w", "b")}
    if "gaussian_B" in params:
        out["gaussian_B"] = fn(params["gaussian_B"])
    return out


def decoder_apply(params, feats: torch.Tensor, compute_dtype=torch.float32,
                  meta: DecoderMeta = PLAIN) -> torch.Tensor:
    """SDF values for interpolated features (..., in_dim) -> (..., 1)."""
    x = apply_positional_embedding(feats, meta.embedder, meta.multires,
                                   params.get("gaussian_B"))
    h = x
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if compute_dtype != torch.float32:
            h = h.to(compute_dtype).float()
            w = w.to(compute_dtype).float()
        h = torch.matmul(h, w) + b
        if i < n - 1:
            h = torch.relu(h)
            if i in meta.skips:
                h = torch.cat([x, h], -1)
    return h


def decoder_params_from_jax(params, device="cuda"):
    """The port's decoder params from a JAX decoder pytree given as numpy
    ({"layers": [{"w", "b"}, ...], "out": {"w", "b"}[, "gaussian_B"]})."""
    layers = list(params["layers"]) + [params["out"]]
    out = {
        name: [torch.as_tensor(np.array(layer[name], np.float32), device=device)
               for layer in layers]
        for name in ("w", "b")
    }
    if "gaussian_B" in params:
        out["gaussian_B"] = torch.as_tensor(np.array(params["gaussian_B"], np.float32),
                                            device=device)
    return out


def decoder_meta_from_jax(meta) -> DecoderMeta:
    """The port's DecoderMeta from JAX's (skips, embedder, multires)."""
    return DecoderMeta(tuple(meta.skips), str(meta.embedder), int(meta.multires))
