"""Shared SDF decoder MLP (port of nerfloam_tpu/models/decoder.py).

16 -> 256 -> 256 -> 1 with ReLU, ``embedder=none``, no skips: the shape
every shipped config uses. Parameters are a plain dict {"w": [...],
"b": [...]} of tensors with the JAX layout, ``w`` of shape (d_in, d_out), so
``decoder_params_from_jax`` is a copy and BA runs Adam over the flat list
``params["w"] + params["b"]``.

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
to XLA outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def init_decoder(depth=2, width=256, in_dim=16, skips=(), embedder="none",
                 multires=0, generator: torch.Generator | None = None, device="cpu"):
    """Decoder params with torch.nn.Linear's default init, U(+-1/sqrt(fan_in))."""
    if tuple(skips) or embedder != "none":
        raise NotImplementedError(
            "decoder skips / positional embedders are not ported yet (ROADMAP queue 1, item 15)"
        )
    dims = [in_dim] + [width] * depth + [1]
    params = {"w": [], "b": []}
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(d_in)
        for name, shape in (("w", (d_in, d_out)), ("b", (d_out,))):
            u = torch.rand(shape, generator=generator, device=device)
            params[name].append((u * 2.0 - 1.0) * bound)
    return params


def decoder_apply(params, feats: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """SDF values for interpolated features (..., in_dim) -> (..., 1)."""
    h = feats
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if compute_dtype != torch.float32:
            h = h.to(compute_dtype).float()
            w = w.to(compute_dtype).float()
        h = torch.matmul(h, w) + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def decoder_params_from_jax(params, device="cpu"):
    """The port's decoder params from a JAX decoder pytree given as numpy
    ({"layers": [{"w", "b"}, ...], "out": {"w", "b"}})."""
    layers = list(params["layers"]) + [params["out"]]
    return {
        name: [torch.as_tensor(np.array(layer[name], np.float32), device=device)
               for layer in layers]
        for name in ("w", "b")
    }
