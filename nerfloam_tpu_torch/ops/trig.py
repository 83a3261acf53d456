"""sin, cos and atan2 of f32 tensors rounded as the JAX package's are on
the CPU, on both devices.

XLA's CPU backend calls the host's libm for ``jnp.sin``, ``jnp.cos`` and
``jnp.arctan2``; glibc 2.36 computes them by the algorithms that
``native/trig.h`` copies (bit-equal to that libm on every float of
[0, pi], ``scripts/trig_every_float.py``). torch's own sin, cos and atan2
round otherwise on 0.02-20% of arguments, and a rotation's angle or a
range-image pixel follows them.

- CPU tensors: the host copies in ``native/trig.cpp`` (the port's own
  library; the host's libm is not called).
- CUDA tensors: one launch of ``csrc/trig.cu`` (the same header compiled
  by nvcc) a call, forward and backward; ``trig_launches`` counts them. An
  operand must be f32 on the card and contiguous, or one-dimensional with
  any stride (a column of an (N, k) array), or ValueError. The kernel has
  no TPU kernel behind it: it replaces the eager sin / cos / atan2 of the
  se3 and scan-to-scan ops.

Each is an autograd function whose backward is JAX's JVP rule on the same
copies: ``g * cos(x)`` for sin, ``-(g * sin(x))`` for cos and ``lax.atan2``'s
``g * (x / (y*y + x*x))`` and ``g * (-y / (y*y + x*x))`` for ``atan2(y, x)``,
each sum of squares contracted as XLA's CPU backend contracts it there,
``fma(y, y, x * x)`` in the first and ``fma(x, x, y * y)`` in the second
(held bit for bit against ``jax.vjp`` of ``jnp.arctan2``).
"""

from __future__ import annotations

import torch

from nerfloam_tpu_torch import kernels, native
from nerfloam_tpu_torch.ops.ieee import fma_f32

trig_launches = 0

SIN, COS, ATAN2 = 0, 1, 2
_NAMES = {SIN: "sin", COS: "cos", ATAN2: "atan2"}


def _host(op: int, *xs: torch.Tensor) -> torch.Tensor:
    """The host copy of ``op`` over contiguous f32 CPU tensors."""
    lib = native.get_trig_lib()
    xs = [x.detach().contiguous() for x in xs]
    out = torch.empty_like(xs[0], memory_format=torch.contiguous_format)
    n = out.numel()
    if n:
        if op == ATAN2:
            lib.nl_atan2f_n(xs[0].data_ptr(), xs[1].data_ptr(), n, out.data_ptr())
        else:
            (lib.nl_sinf_n if op == SIN else lib.nl_cosf_n)(xs[0].data_ptr(), n, out.data_ptr())
    return out


def _flat_stride(name: str, label: str, t: torch.Tensor) -> int:
    """The element stride of ``t`` read as a flat array: 1 if contiguous,
    its stride if one-dimensional; anything else raises ValueError."""
    if t.is_contiguous():
        return 1
    if t.dim() == 1:
        return t.stride(0)
    raise ValueError(f"{name}: {label} must be contiguous or one-dimensional; got shape "
                     f"{tuple(t.shape)} with strides {tuple(t.stride())}")


def _check(name: str, *xs: torch.Tensor) -> None:
    x0 = xs[0]
    for label, t in zip("xyg", xs):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be f32; got {t.dtype}")
        if t.device != x0.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: {label} on {t.device}, expected {x0.device} (cpu or cuda)")
        if t.shape != x0.shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected "
                             f"{tuple(x0.shape)}")


def _launch_fwd(op: int, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    global trig_launches
    name = _NAMES[op]
    sa = _flat_stride(name, "x", a)
    sb = _flat_stride(name, "y", b) if b is not None else 0
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    n = out.numel()
    if n:
        err = kernels.lib().nl_trig_fwd(op, a.data_ptr(), sa, 0 if b is None else b.data_ptr(),
                                        sb, n, out.data_ptr(), kernels.stream_ptr(a.device))
        kernels.check(err, f"trig {name}")
        trig_launches += 1
    return out


def _launch_bwd(op: int, a, b, g) -> tuple:
    global trig_launches
    name = _NAMES[op] + " backward"
    sa, sg = _flat_stride(name, "x", a), _flat_stride(name, "g", g)
    sb = _flat_stride(name, "y", b) if b is not None else 0
    ga = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    gb = torch.empty(a.shape, dtype=torch.float32, device=a.device) if b is not None else None
    n = ga.numel()
    if n:
        err = kernels.lib().nl_trig_bwd(
            op, a.data_ptr(), sa, 0 if b is None else b.data_ptr(), sb, g.data_ptr(), sg, n,
            ga.data_ptr(), 0 if gb is None else gb.data_ptr(), kernels.stream_ptr(a.device))
        kernels.check(err, f"trig {name}")
        trig_launches += 1
    return ga, gb


def atan2_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain twin for tensors on any device: the host copy,
    through the CPU."""
    return _host(ATAN2, y.cpu(), x.cpu()).to(y.device)


def _fwd(op: int, *xs: torch.Tensor) -> torch.Tensor:
    _check(_NAMES[op], *xs)
    if xs[0].device.type == "cpu":
        return _host(op, *xs)
    return _launch_fwd(op, xs[0], xs[1] if op == ATAN2 else None)


def _bwd_plain(op: int, a, b, g):
    """The backward's plain form (CPU tensors): JAX's JVP rules."""
    if op == SIN:
        return g * _host(COS, a), None
    if op == COS:
        return -(g * _host(SIN, a)), None
    return g * (b / fma_f32(a, a, b * b)), g * (-a / fma_f32(b, b, a * a))


def _bwd(op: int, a, b, g):
    if a.device.type == "cpu":
        return _bwd_plain(op, a, b, g)
    _check(_NAMES[op] + " backward", a, *((b,) if b is not None else ()), g)
    return _launch_bwd(op, a, b, g)


class _Sin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _fwd(SIN, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _bwd(SIN, x, None, g)[0]


class _Cos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _fwd(COS, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _bwd(COS, x, None, g)[0]


class _Atan2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return _fwd(ATAN2, y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        return _bwd(ATAN2, y, x, g)


def sin(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sin(x)`` of f32 ``x``, bit for bit on both devices."""
    return _Sin.apply(x)


def cos(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cos(x)`` of f32 ``x``, bit for bit on both devices."""
    return _Cos.apply(x)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.arctan2(y, x)`` of f32 tensors of one shape, bit for bit on
    both devices."""
    return _Atan2.apply(y, x)
