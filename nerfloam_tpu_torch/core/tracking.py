"""Frame-to-map tracking (port of nerfloam_tpu/core/tracking.py, single
device): the Gauss-Newton / LM tracker (40-381) and the Adam tracker
(383-497).

GN, per frame: ``ray_prep`` (csrc/ray_prep.cu) takes the drawn rays'
directions, ranges and measured depths in one launch; K4 builds the hit
table (hits sampler) or K9a marches the
occupancy cdf (grid sampler) at the initial pose, launched as part of
making the frame's placer, which checks and packs K9b's per-frame
arguments once (``raycast.CdfPlacer.march``). Per
iteration: K1 (hits) or K9b then K8 (grid) place the samples and
interpolate their features at
the iteration's pose, K8 adds the band/anchor columns of the quality
stack (explicit depths around the measured distance), the decoder runs
forward and backward to d sdf / d feats over all columns at once, and one
K2 launch (with the packed gradient off) turns that into the spatial
gradient g per sample. K3 (``gn_system``, csrc/gn_system.cu) forms the
residuals, the count-balanced weights and the 6x6 normal equations; with
``TrackParams.s2s`` set, K11b (``core.scan2scan.s2s_system``) adds the
scan-to-scan point-to-plane term on the same rays against the previous
scan's range image into K3's H, b and loss in place, with the iteration's
rotation of the ray directions; the damped LM solve stays in torch, and
``lm_step`` (csrc/lm_step.cu) takes the rest of the update, trust region to
log map, in one launch and hands the next iteration its rotation.

Adam (``track_frame``) always uses the grid sampler, as JAX does: one ray
draw, one placer made by its K9a march per frame at the initial pose; per
iteration the grid render_rays (K9b, K8, decoder, one K2 in the
backward), the sdf losses
with the band target, the pose gradient by autograd, and an
``optax.scale_by_adam`` step. With ``TrackParams.resample_rays`` (the
reference-exact fallback) every iteration draws fresh rays and marches
them at the current pose instead (a ``CdfPlacer.march`` an iteration);
the GN tracker ignores the knob, as JAX's does.

Neither loop reads a value back to the host: shapes are static,
``torch.linalg.solve_ex`` skips the error check that would synchronise,
and the total-miss fallback is a ``torch.where`` on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core.losses import sdf_losses
from nerfloam_tpu_torch.core.render import (
    ActiveField,
    columns_fwd,
    extra_surface_z,
    grid_columns_fwd,
    hits_field_bwd,
    render_rays,
)
from nerfloam_tpu_torch.core.scan2scan import s2s_system
from nerfloam_tpu_torch.map.voxel_map import MapConfig, MapState, rdiv
from nerfloam_tpu_torch.models.decoder import PLAIN, DecoderMeta, decoder_apply
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.ieee import const, div, norm3, norm3_plain, sqrt_rn
from nerfloam_tpu_torch.ops.raycast import (
    CdfPlacer,
    RaycastConfig,
    build_hit_table,
    uniform_jitter,
)
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices
from nerfloam_tpu_torch.parallel.sharding import dp_cols

# launches on CUDA tensors (plain integers; chip_smoke.py resets and reads them)
gn_system_launches = 0  # K3
gn_sums_launches = 0  # K3's dp form
gn_maturity_launches = 0  # K3's maturity form (one-launch or dp)
lm_step_launches = 0
ray_prep_launches = 0
_K3 = "gn_system"
_F32 = torch.float32
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam defaults


class TrackParams(NamedTuple):
    n_rays: int
    num_iterations: int
    truncation: float
    max_depth: float
    fs_weight: float
    sdf_weight: float
    compute_dtype: str = "float32"
    surface_anchor: int = 0  # anchor columns at the measured point (its weight)
    band_samples: int = 0    # stratified columns across the truncation band
    s2s: object = None       # core.scan2scan.Scan2ScanParams | None: add the
    #   scan-to-scan point-to-plane term to the GN system (GN tracker only)
    resample_rays: bool = False  # Adam tracker: fresh rays and march every iteration
    maturity_warmup: int = 0  # > 0: the GN tracker weighs each sample by its voxel's
    #   maturity, floor + (1 - floor) min(count / warmup, 1), count the BA steps
    #   that touched its row (MapState.upd_count)
    maturity_floor: float = 0.25


class TrackResult(NamedTuple):
    pose: torch.Tensor       # (6,)
    hit_count: torch.Tensor  # () int: hit rays at the last iteration
    loss: torch.Tensor       # () last-iteration loss


@functools.lru_cache(maxsize=None)
def _bias_corrections(t: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) as optax forms them under jit: b^t rounded once
    to float32 (XLA's power; the double power rounded to float32 equals it
    for every t under 2958), then 1 - it in float32. 0-d float32 tensors on
    ``device``, made once per (t, device): a tensor divisor keeps the IEEE
    division that a Python one turns into a reciprocal multiply on CUDA."""
    b = np.asarray([_B1, _B2], np.float32).astype(np.float64)
    bc = np.float32(1.0) - (b ** t).astype(np.float32)
    return tuple(torch.tensor(v, device=device) for v in bc)


def scale_by_adam_(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, t: int) -> torch.Tensor:
    """One ``optax.scale_by_adam()`` step (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, bias-corrected) at step t >= 1: updates the moments mu and
    nu in place and returns the update (applied as ``p - lr * update``).
    Bit for bit optax's: each moment (1 - b) * g^k + b * m as two rounded
    products and a rounded add (no fused multiply-add), the bias
    corrections as optax forms them (``_bias_corrections``), two IEEE
    divisions and a correctly rounded sqrt."""
    bc1, bc2 = _bias_corrections(t, g.device)
    mu.mul_(_B1).add_(g * (1.0 - _B1))
    nu.mul_(_B2).add_((g * g).mul_(1.0 - _B2))
    return (mu / bc1) / (sqrt_rn(nu / bc2) + _EPS)


def _bias_ray(pcos, sdf_bias, dev):
    """Per-ray band target: sdf_bias (2,) [ground, non-ground] or None = 0."""
    b2 = (torch.zeros((2,), device=dev) if sdf_bias is None
          else torch.as_tensor(sdf_bias, dtype=torch.float32, device=dev).reshape(-1)[:2])
    return torch.where(pcos < 0.999, b2[0], b2[1])


class RayPrep(NamedTuple):
    """A ray draw's per-ray setup (``ray_prep``), for points p (..., 3)."""

    dirs: torch.Tensor      # (..., 3) p / (|p| + 1e-8)
    t_cap: torch.Tensor     # (...) the useful range: |p| + truncation / max(cos, 0.05) + 0.5,
    #                         at most max_depth
    d_meas: torch.Tensor    # (...) |p| cos
    depth_ok: torch.Tensor  # (...) bool: 0 < d_meas < max_depth
    dnorm: torch.Tensor     # (...) |p|


def ray_prep_plain(pts: torch.Tensor, pcos: torch.Tensor, truncation: float,
                   max_depth: float) -> RayPrep:
    """Plain torch twin of ``ray_prep``: the directions, the useful range
    (JAX's ``t_cap_for``), the measured depth and its gate from one
    ``ieee.norm3_plain`` of the points, op by op as JAX rounds them
    (tracking.py:156-160, 374-381)."""
    n = norm3_plain(pts)
    dirs = pts / (n[..., None] + 1e-8)
    t_cap = torch.clamp(n + rdiv(truncation, torch.clamp(pcos, min=0.05)) + 0.5, max=max_depth)
    d_meas = n * pcos
    return RayPrep(dirs, t_cap, d_meas, (d_meas > 0.0) & (d_meas < max_depth), n)


def ray_prep(pts: torch.Tensor, pcos: torch.Tensor, truncation: float,
             max_depth: float) -> RayPrep:
    """A ray draw's setup: directions, t_cap, measured depth, its gate and
    the points' lengths (the XLA fusion of nerfloam_tpu/core/tracking.py:
    156-160 and t_cap_for, and BA's superset's). Points (..., 3) and their
    cosines (...), contiguous f32 on one device. CPU tensors take
    ``ray_prep_plain``; CUDA tensors one launch of csrc/ray_prep.cu (none
    for no ray), equal to it bit for bit; anything the kernel cannot read
    raises ValueError."""
    name, dev = "ray_prep", pts.device
    if dev.type == "cpu":
        return ray_prep_plain(pts, pcos, truncation, max_depth)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    global ray_prep_launches
    kernels.expect(name, dev, _F32, pts=pts, pcos=pcos)
    kernels.expect_shape(name, pts=(pts, tuple(pcos.shape) + (3,)))
    n = pcos.numel()
    out = torch.empty((6 * n,), dtype=_F32, device=dev)
    depth_ok = torch.empty(pcos.shape, dtype=torch.bool, device=dev)
    if n:
        o = out.data_ptr()
        kernels.check(kernels.lib().nl_ray_prep(
            pts.data_ptr(), pcos.data_ptr(), n, truncation, max_depth, o, o + 12 * n, o + 16 * n,
            o + 20 * n, depth_ok.data_ptr(), kernels.stream_ptr(dev)), name)
        ray_prep_launches += 1
    return RayPrep(out[:3 * n].view(pts.shape), out[3 * n:4 * n].view(pcos.shape),
                   out[4 * n:5 * n].view(pcos.shape), depth_ok, out[5 * n:].view(pcos.shape))


def _gn_terms(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp: TrackParams, bias_ray):
    """K3's per-sample classes, residuals and Jacobians (tracking.py:
    217-244, 300-302): (front, band, r, J (N, M, 6))."""
    T = tp.truncation
    if bias_ray is None:
        bias_ray = torch.zeros_like(pcos)
    zc = z * pcos[:, None]
    d = d_meas[:, None]
    front = (zc < (d - T)) & vmask
    band = vmask & ~front & ~(zc > (d + T)) & depth_ok[:, None]
    r = torch.where(front, sdf - 1.0, (zc + (sdf - bias_ray[:, None]) * T) - d)
    jscale = torch.where(front, 1.0, T)
    q = xyz - t_pos
    gj = g * jscale[..., None]
    J = torch.cat([gj, torch.linalg.cross(q, gj, dim=-1)], -1)
    return front, band, r, J


def maturity_weights(cnt_active, aid, tp: TrackParams):
    """Each sample's voxel-maturity weight (JAX tracking.py:192-195), op by
    op as JAX rounds it: floor + (1 - floor) min(cnt / warmup, 1), cnt the
    BA-touch count (f32) of the sample's active row, ``aid`` clamped at 0."""
    cnt = cnt_active[torch.clamp(aid, min=0).long()]
    frac = torch.clamp(div(cnt, float(tp.maturity_warmup)), max=1.0)
    return tp.maturity_floor + (1.0 - tp.maturity_floor) * frac


def gn_system_plain(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp: TrackParams,
                    bias_ray=None, mat_w=None):
    """Plain torch twin of K3: residuals, count-balanced weights and the
    6x6 normal equations (tracking.py:217-244, 300-315), the band target
    being sdf = bias_ray (N,) (None = 0); ``mat_w`` (N, M+K) the samples'
    maturity weights multiplied into the weights (None: none). Returns
    (H, b, loss)."""
    front, band, r, J = _gn_terms(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp,
                                  bias_ray)
    num_fs = front.sum()
    num_sdf = band.sum()
    tot = torch.clamp(num_fs + num_sdf, min=1).to(torch.float32)
    w_fs = tp.fs_weight * (1.0 - num_fs / tot)
    w_sdf = tp.sdf_weight * (1.0 - num_sdf / tot)
    w = torch.where(front, w_fs, w_sdf) * (front | band)
    if mat_w is not None:
        w = w * mat_w
    Jw = J * w[..., None]
    H = torch.einsum("nmi,nmj->ij", Jw, J)
    b = torch.einsum("nmi,nm->i", Jw, r)
    return H, b, torch.sum(w * r * r)


_CLS = 28  # K3's sums a class: J J^T's upper triangle (21), J r (6), r^2 (1)
GN_SUMS = 2 * _CLS + 2  # K3's dp form: the front sums, the band sums, the two counts
_UPPER = [(a, c) for a in range(6) for c in range(a, 6)]  # J J^T's upper entries, in order
_H_OF_UPPER: dict = {}  # device -> (36,) index of H's entries in the upper-entry order


def gn_sums_plain(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp: TrackParams,
                  bias_ray=None, mat_w=None):
    """Plain torch twin of K3's dp form (``GnSystem(..., sums=True)``): its
    unweighted per-class sums, (58,) f32: for the front samples then the
    band samples the upper triangle of sum J J^T (21, row by row), sum J r
    (6) and sum r^2 (1); then the two classes' counts, each sample's
    contributions weighted by ``mat_w`` (N, M+K) where given, its counts
    not. ``gn_combine`` makes (H, b, loss) of them once they are
    all-reduced."""
    front, band, r, J = _gn_terms(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp,
                                  bias_ray)
    iu = torch.tensor(_UPPER, device=J.device).T
    parts = []
    for cls in (front, band):
        m = cls.to(torch.float32)
        if mat_w is not None:
            m = m * mat_w
        Jm = J * m[..., None]
        parts += [torch.einsum("nmi,nmj->ij", Jm, J)[iu[0], iu[1]],
                  torch.einsum("nmi,nm->i", Jm, r), torch.sum(m * r * r)[None]]
    parts.append(torch.stack([front.sum(), band.sum()]).to(torch.float32))
    return torch.cat(parts)


def gn_combine(sums: torch.Tensor, tp: TrackParams):
    """(H (6, 6), b (6,), loss ()) from K3's 58 sums (all-reduced over the
    dp ranks): the count-balanced weights of the global counts, w_fs
    S_front + w_sdf S_band, as K3's one-launch form combines them."""
    nf, ns = sums[2 * _CLS], sums[2 * _CLS + 1]
    tot = torch.clamp(nf + ns, min=1.0)
    w_fs = tp.fs_weight * (1.0 - nf / tot)
    w_sdf = tp.sdf_weight * (1.0 - ns / tot)
    comb = w_fs * sums[:_CLS] + w_sdf * sums[_CLS:2 * _CLS]
    idx = _H_OF_UPPER.get(sums.device)
    if idx is None:
        at = {ac: k for k, ac in enumerate(_UPPER)}
        idx = _H_OF_UPPER[sums.device] = torch.tensor(
            [at[(min(i, j), max(i, j))] for i in range(6) for j in range(6)], device=sums.device)
    return comb[idx].view(6, 6), comb[21:27], comb[27]


class GnSystem:
    """K3 prepared for one tracked frame: the per-ray inputs, fixed over the
    frame's iterations (pcos, d_meas, bias_ray f32 (N,), depth_ok bool
    (N,)), ``tp``'s truncation and weights and the column count ``n_cols``
    (M + K) are checked once, and on the card the kernel's scratch (the
    partial rows and the last-block counter, which every call leaves at
    zero) and the outputs H (6, 6), b (6,) and loss () are allocated once.
    Each call ``system(xyz, t_pos, z, sdf, g, vmask)`` checks only the
    iteration's samples (xyz, g (N, n_cols, 3) and z, sdf (N, n_cols) f32,
    vmask bool (N, n_cols), t_pos f32 (3,); contiguous, on pcos's device)
    and raises ValueError on what it would have to convert, on the CPU
    too. On the card it makes one launch and returns the object's own H,
    b and loss, overwritten by its next call: the tracker consumes them
    (K11b adds into them in place, the LM step reads them) within the
    iteration. CPU tensors take ``gn_system_plain``. With ``sums=True``
    (the dp form) a call returns K3's 58 per-class sums instead (its own
    buffer; ``gn_sums_plain`` on the CPU), for the caller to all-reduce and
    ``gn_combine``. With ``tp.maturity_warmup`` > 0 (the maturity form, of
    either) ``cnt`` (A,) f32 is the active rows' BA-touch counts, fixed
    over the frame, and each call takes ``aid`` (N, n_cols) int32, the
    samples' active rows: each sample's terms are weighted by
    ``maturity_weights``, in the same one launch."""

    def __init__(self, pcos, d_meas, depth_ok, bias_ray, tp: TrackParams, n_cols: int,
                 sums: bool = False, cnt=None):
        dev = pcos.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{_K3}: unsupported device {dev}")
        kernels.expect(_K3, dev, _F32, pcos=pcos, d_meas=d_meas, bias_ray=bias_ray)
        kernels.expect(_K3, dev, torch.bool, depth_ok=depth_ok)
        N = pcos.shape[0] if pcos.dim() == 1 else -1
        kernels.expect_shape(_K3, pcos=(pcos, (N,)), d_meas=(d_meas, (N,)),
                             depth_ok=(depth_ok, (N,)), bias_ray=(bias_ray, (N,)))
        if N * n_cols >= 1 << 24:
            raise ValueError(f"{_K3}: {N} x {n_cols} samples; the kernel counts them in f32, "
                             "exact below 2^24")
        self.maturity = tp.maturity_warmup > 0
        if self.maturity:
            kernels.expect(_K3, dev, _F32, cnt=cnt)
            if cnt.dim() != 1 or cnt.shape[0] < 1:
                raise ValueError(f"{_K3}: cnt must be (A,) with A >= 1; got {tuple(cnt.shape)}")
        elif cnt is not None:
            raise ValueError(f"{_K3}: cnt given with tp.maturity_warmup = 0")
        self._cnt = cnt
        self.device, self.tp, self.sums = dev, tp, sums
        self._rays = (pcos, d_meas, depth_ok, bias_ray)
        self._s_shape, self._x_shape = (N, n_cols), (N, n_cols, 3)
        self._index = -2  # matches no tensor's get_device(): CPU calls take the full checks
        if dev.type == "cpu":
            return
        self._index = pcos.get_device()
        lib = kernels.lib()
        # the partial rows, then the counter (0.0's bits are an unsigned 0)
        self._scratch = torch.zeros((lib.nl_gn_partial_values() * lib.nl_gn_max_blocks() + 1,),
                                    dtype=_F32, device=dev)
        out = torch.empty((43 + (GN_SUMS if sums else 0),), dtype=_F32, device=dev)
        self._out = (out[:36].view(6, 6), out[36:42], out[42])
        self._sums = out[43:] if sums else None
        self._launch = lib.nl_gn_system
        self._fixed = (*(t.data_ptr() for t in self._rays), N, n_cols, tp.truncation,
                       tp.fs_weight, tp.sdf_weight, self._scratch.data_ptr(),
                       *(t.data_ptr() for t in self._out),
                       self._sums.data_ptr() if sums else None)
        if self.maturity:
            self._launch_m = lib.nl_gn_system_maturity
            self._mat = (cnt.data_ptr(), cnt.shape[0], float(tp.maturity_warmup),
                         float(tp.maturity_floor), float(1.0 - tp.maturity_floor))

    def __call__(self, xyz, t_pos, z, sdf, g, vmask, aid=None):
        if self.maturity:
            return self._call_maturity(xyz, t_pos, z, sdf, g, vmask, aid)
        if aid is not None:
            raise ValueError(f"{_K3}: aid given with tp.maturity_warmup = 0")
        index, s, x = self._index, self._s_shape, self._x_shape
        # the usual case on the card in one expression; anything else, and
        # every CPU call, goes through the full checks, which raise
        if not (xyz.dtype is _F32 and z.dtype is _F32 and sdf.dtype is _F32 and g.dtype is _F32
                and t_pos.dtype is _F32 and vmask.dtype is torch.bool and z.shape == s
                and sdf.shape == s and vmask.shape == s and xyz.shape == x and g.shape == x
                and t_pos.shape == (3,) and xyz.is_contiguous() and z.is_contiguous()
                and sdf.is_contiguous() and g.is_contiguous() and vmask.is_contiguous()
                and t_pos.is_contiguous() and xyz.get_device() == index
                and z.get_device() == index and sdf.get_device() == index
                and g.get_device() == index and vmask.get_device() == index
                and t_pos.get_device() == index):
            self._check(xyz, t_pos, z, sdf, g, vmask)
            if index < 0:
                pcos, d_meas, depth_ok, bias_ray = self._rays
                plain = gn_sums_plain if self.sums else gn_system_plain
                return plain(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, self.tp,
                             bias_ray)
        global gn_system_launches, gn_sums_launches
        err = self._launch(xyz.data_ptr(), z.data_ptr(), sdf.data_ptr(), g.data_ptr(),
                           vmask.data_ptr(), *self._fixed[:4], t_pos.data_ptr(),
                           *self._fixed[4:], kernels.raw_stream(index))
        if err:
            self._scratch.zero_()  # the counter may not be zero
            kernels.check(err, _K3)
        if self.sums:
            gn_sums_launches += 1
            return self._sums
        gn_system_launches += 1
        return self._out

    def _call_maturity(self, xyz, t_pos, z, sdf, g, vmask, aid):
        """The maturity form: the full checks every call, one launch."""
        self._check(xyz, t_pos, z, sdf, g, vmask)
        if aid is None:
            raise ValueError(f"{_K3}: the maturity form takes each sample's active row, aid")
        kernels.expect(_K3, self.device, torch.int32, aid=aid)
        kernels.expect_shape(_K3, aid=(aid, self._s_shape))
        if self._index < 0:
            pcos, d_meas, depth_ok, bias_ray = self._rays
            plain = gn_sums_plain if self.sums else gn_system_plain
            return plain(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, self.tp, bias_ray,
                         maturity_weights(self._cnt, aid, self.tp))
        global gn_maturity_launches
        err = self._launch_m(xyz.data_ptr(), z.data_ptr(), sdf.data_ptr(), g.data_ptr(),
                             vmask.data_ptr(), *self._fixed[:4], t_pos.data_ptr(),
                             *self._fixed[4:], self._mat[0], aid.data_ptr(), *self._mat[1:],
                             kernels.raw_stream(self._index))
        if err:
            self._scratch.zero_()  # the counter may not be zero
            kernels.check(err, _K3)
        gn_maturity_launches += 1
        return self._sums if self.sums else self._out

    def _check(self, xyz, t_pos, z, sdf, g, vmask):
        dev = self.device
        kernels.expect(_K3, dev, _F32, xyz=xyz, t_pos=t_pos, z=z, sdf=sdf, g=g)
        kernels.expect(_K3, dev, torch.bool, vmask=vmask)
        kernels.expect_shape(_K3, xyz=(xyz, self._x_shape), t_pos=(t_pos, (3,)),
                             z=(z, self._s_shape), sdf=(sdf, self._s_shape), g=(g, self._x_shape),
                             vmask=(vmask, self._s_shape))


def gn_system(xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp: TrackParams,
              bias_ray=None):
    """K3. Replaces the XLA fusion of nerfloam_tpu/core/tracking.py:217-244
    (_residual_parts) and 300-315 (the H and b einsums): per-class sums in
    one pass, then the balancing weights, by a deterministic reduction in
    one launch (csrc/gn_system.cu). One call of a ``GnSystem`` made for it
    (see there: inputs are checked, never converted; bias_ray None = 0).
    CPU tensors take ``gn_system_plain``. Shapes: (N, M+K) samples, (N,)
    rays; returns (H (6, 6), b (6,), loss)."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_K3}: unsupported device {xyz.device}")
    if bias_ray is None:
        bias_ray = torch.zeros_like(pcos)
    return GnSystem(pcos, d_meas, depth_ok, bias_ray, tp, z.shape[1])(xyz, t_pos, z, sdf, g,
                                                                     vmask)


def trust_region(delta):
    """The LM steps (..., 6) clipped to 0.5 m of translation and 0.1 rad of
    rotation (tracking.py:329-332): each half scaled by min(1, r / (|v| +
    1e-12)), r / (...) one IEEE division as in JAX. Returns (dt, dth)."""
    dt, dth = delta[..., :3].contiguous(), delta[..., 3:].contiguous()  # a batch: copies
    dt = dt * torch.clamp(rdiv(0.5, norm3(dt, keepdim=True) + 1e-12), max=1.0)
    dth = dth * torch.clamp(rdiv(0.1, norm3(dth, keepdim=True) + 1e-12), max=1.0)
    return dt, dth


def lm_step_plain(pose6, step):
    """Plain torch twin of ``lm_step``: the LM update after the solve
    (tracking.py:326-334), op by op. ``step`` (..., 6) is the solve's
    solution, delta = -step; returns (the new pose (..., 6), its rotation
    ``se3.pose_rotation`` (..., 3, 3))."""
    dt, dth = trust_region(-step)
    R_new = se3.compose_matrices(se3.exp_so3(dth), se3.pose_rotation(pose6))
    new = torch.cat([pose6[..., :3] + dt, se3.log_so3(R_new)], -1)
    return new, se3.pose_rotation(new)


def lm_step(pose6, step):
    """The LM update after the damped solve, replacing the XLA fusion of
    nerfloam_tpu/core/tracking.py:326-334: trust region (0.5 m / 0.1 rad),
    exp_so3 of the rotation step left-multiplied onto the pose's, log_so3,
    the translation added; also the new pose's rotation matrix, which the
    next iteration rotates its rays with. ``pose6`` and ``step`` (the
    solve's solution; delta = -step) are (..., 6) contiguous f32 on one
    device, needing no gradient. CPU tensors take ``lm_step_plain``; CUDA
    tensors one launch of csrc/lm_step.cu (one thread a step): its
    translation equal to the twin's, its rotation within a few ulp (sinf
    and atan2f are CUDA's). Returns (pose (..., 6), R (..., 3, 3)), views
    of one new buffer."""
    name, dev = "lm_step", pose6.device
    if dev.type == "cpu":
        return lm_step_plain(pose6, step)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    global lm_step_launches
    kernels.expect(name, dev, _F32, pose6=pose6, step=step)
    shape = tuple(pose6.shape)
    if not shape or shape[-1] != 6:
        raise ValueError(f"{name}: pose6 must be (..., 6); got {shape}")
    kernels.expect_shape(name, step=(step, shape))
    if torch.is_grad_enabled() and (pose6.requires_grad or step.requires_grad):
        raise ValueError(f"{name}: no backward; pass tensors that need no gradient")
    n = pose6.numel() // 6
    out = pose6.new_empty(15 * n)
    if n:
        o = out.data_ptr()
        kernels.check(kernels.lib().nl_lm_step(step.data_ptr(), pose6.data_ptr(), n, o,
                                               o + 24 * n, kernels.stream_ptr(dev)), name)
        lm_step_launches += 1
    return out[:6 * n].view(shape), out[6 * n:].view(shape[:-1] + (3, 3))


# 1e-6 I, the damping's floor, made once per device
_DAMP_FLOOR = tuple(tuple(1e-6 if i == j else 0.0 for j in range(6)) for i in range(6))


def lm_update(pose6, H, b, lam):
    """Damped solve, trust region (0.5 m / 0.1 rad), left-multiplied update
    (``lm_step``). Returns (the new pose, its rotation)."""
    Hd = H + lam * torch.diag(torch.diag(H)) + const(_DAMP_FLOOR, H.dtype, H.device)
    return lm_step(pose6, torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0])


def field_and_grad(decoder_params, feats, xyz, aid, valid, packed, voxel_size, compute_dtype,
                   dec_meta: DecoderMeta = PLAIN):
    """sdf and d sdf / d xyz per sample: decoder forward and backward to
    d sdf / d feats in torch, then K2 with the packed gradient off."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        sdf = decoder_apply(decoder_params, f, compute_dtype, dec_meta)[..., 0]
        (dfeats,) = torch.autograd.grad(sdf.sum(), f)
    g, _ = hits_field_bwd(dfeats, xyz, aid, valid, packed, voxel_size, want_dpacked=False)
    return sdf.detach(), g


@torch.no_grad()
def track_frame_gn(map_state: MapState, map_cfg: MapConfig, rc: RaycastConfig, tp: TrackParams,
                   decoder_params, init_pose, points, points_cos, points_valid,
                   generator: torch.Generator | None = None, sdf_bias=None,
                   prev_scan=None, dec_meta: DecoderMeta = PLAIN, group=None) -> TrackResult:
    """LM pose tracking on the truncated-SDF residuals over one frame's
    (padded) points. ``sdf_bias`` (2,) [ground, non-ground] is the band
    target (the mapped field's surface offset, bias transfer); None = 0.
    ``prev_scan`` (core.scan2scan.PrevScan) is the rasterized previous scan
    of the s2s term, used iff ``tp.s2s`` is set. ``dec_meta``: the
    decoder's skips and embedder.

    ``group``: a ``torch.distributed`` group of dp ranks (JAX's sharded
    ``_track_gn_core``, tracking.py:145-153, 310-340). Every rank draws the
    frame's rays and each iteration's jitter and band draws globally and
    keeps its contiguous block of n_rays / dp; K3 takes its dp form, whose
    58 sums (and K11b's H, b and loss) are all-reduced in one collective an
    iteration before ``gn_combine`` weighs them by the global counts; every
    rank then solves the same system and takes the same LM step. The hit
    count is all-reduced once, after the loop. None: one device."""
    if rc.sampler not in ("hits", "grid"):
        raise ValueError(f"unknown sampler {rc.sampler!r}")
    dev = points.device
    compute_dtype = getattr(torch, tp.compute_dtype)
    vs = map_cfg.voxel_size
    packed = map_state.packed
    ridx, rvalid = sample_ray_indices(points_valid, tp.n_rays, generator)
    rows = dp_cols(group, tp.n_rays)  # this rank's block of the global draws
    ridx, rvalid = ridx[rows], rvalid[rows]
    pts = points[ridx]
    pcos = points_cos[ridx]
    dirs, t_cap, d_meas, depth_ok, dnorm = ray_prep(pts, pcos, tp.truncation, tp.max_depth)
    bias_ray = _bias_ray(pcos, sdf_bias, dev)
    n_extra = tp.surface_anchor + tp.band_samples
    # what stays fixed over the frame, checked once: K8's grid and K3's rays
    field = ActiveField(map_state, map_cfg)
    # voxel maturity (JAX tracking.py:184-197): the active rows' BA-touch
    # counts, gathered once a frame; K3 weighs each sample by its row's
    cnt = (map_state.upd_count[map_state.active_ids.long()].to(torch.float32)
           if tp.maturity_warmup > 0 else None)
    system = GnSystem(pcos, d_meas, depth_ok, bias_ray, tp, rc.n_samples + n_extra,
                      sums=group is not None, cnt=cnt)

    s2s_on = tp.s2s is not None and prev_scan is not None

    R = se3.pose_rotation(init_pose)  # then lm_step's, one iteration to the next
    wdirs0 = torch.matmul(dirs, R.transpose(-1, -2))  # se3.rotate_dirs(init_pose, dirs)
    origin0 = se3.pose_translation(init_pose).expand_as(wdirs0)
    if rc.sampler == "hits":
        ht0 = build_hit_table(map_state, map_cfg, rc, origin0, wdirs0, t_cap)
        ray_hit = ht0.ray_mask
    else:  # K9a once, into the placer that checks and packs K9b's per-frame arguments once
        placer = CdfPlacer.march(map_state, map_cfg, rc, origin0, wdirs0, t_cap, rc.n_samples)

    pose6 = init_pose
    lam = 1e-2
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for it in range(tp.num_iterations):
        wdirs = torch.matmul(dirs, R.transpose(-1, -2))  # se3.rotate_dirs(pose6, dirs)
        t_pos = se3.pose_translation(pose6)
        origin = t_pos.expand_as(wdirs)
        u = uniform_jitter((tp.n_rays, rc.n_samples), generator, dev)[rows]
        extra = None
        if n_extra:
            ub = (torch.rand((tp.n_rays, tp.band_samples), generator=generator, device=dev)[rows]
                  if tp.band_samples else None)
            ez = extra_surface_z(dnorm, pcos, tp.truncation, tp.surface_anchor, tp.band_samples, ub)
            extra = (field, ez, rvalid)
        if rc.sampler == "hits":
            z, valid, aid, xyz, feats = columns_fwd(ht0, u, origin, wdirs, packed, vs, extra)
        else:
            (z, valid, aid, xyz, feats), ray_hit = grid_columns_fwd(
                field, placer, u, origin, wdirs, packed, extra)
        vmask = valid & rvalid[:, None]
        sdf, g = field_and_grad(decoder_params, feats, xyz, aid, valid, packed, vs, compute_dtype,
                                dec_meta)
        mat = (aid,) if cnt is not None else ()
        if group is None:
            H, b, loss = system(xyz, t_pos, z, sdf, g, vmask, *mat)
            if s2s_on:
                # adds in place into K3's outputs, which its next call overwrites
                H, b, loss = s2s_system(tp.s2s, prev_scan, pose6, pts, rvalid, R, (H, b, loss))
        else:  # K3's sums (and K11b's system) over every rank's rays, in one all-reduce
            parts = [system(xyz, t_pos, z, sdf, g, vmask, *mat)]
            if s2s_on:
                Hs, bs, ls = s2s_system(tp.s2s, prev_scan, pose6, pts, rvalid, R)
                parts += [Hs.reshape(36), bs, ls.reshape(1)]
            buf = torch.cat(parts)
            dist.all_reduce(buf, group=group)
            H, b, loss = gn_combine(buf[:GN_SUMS], tp)
            if s2s_on:
                H, b, loss = (H + buf[GN_SUMS:GN_SUMS + 36].view(6, 6),
                              b + buf[GN_SUMS + 36:GN_SUMS + 42], loss + buf[GN_SUMS + 42])
        pose6, R = lm_update(pose6, H, b, lam)
        hits = (ray_hit & rvalid).sum()
    if group is not None:
        dist.all_reduce(hits, group=group)
    pose6 = torch.where(hits > 0, pose6, init_pose)
    return TrackResult(pose6, hits, loss)


def adam_loss(field: ActiveField, tp: TrackParams, decoder_params, pose6, dirs, pts, dnorm, pcos,
              rvalid, placer: CdfPlacer, u, band_u, bias_ray, dec_meta: DecoderMeta = PLAIN):
    """The Adam tracker's loss at pose6 (JAX tracking.py:435-470, fixed
    rays): grid render_rays of the map's packed table through ``placer``
    and ``field`` (the frame's CdfPlacer over the hoisted march and its
    ActiveField over the map) with jitter u, the anchor and band columns
    (jitter band_u), then ``sdf_losses`` with the per-ray band target
    bias_ray (R,). ``dnorm`` (R,): |pts|, from the draw's ``ray_prep``.
    Returns (loss, RenderOutput)."""
    compute_dtype = getattr(torch, tp.compute_dtype)
    wdirs = se3.rotate_dirs(pose6, dirs)
    origin = se3.pose_translation(pose6).expand_as(wdirs)
    extra = None
    if tp.surface_anchor or tp.band_samples:
        ez = extra_surface_z(dnorm, pcos, tp.truncation, tp.surface_anchor, tp.band_samples,
                             band_u)
        extra = (field, ez, rvalid)
    out = render_rays(field.state.packed, decoder_params, field, origin, wdirs, rvalid, placer, u,
                      compute_dtype, extra, dec_meta=dec_meta)
    loss, _ = sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, pts, pcos,
                         tp.truncation, tp.max_depth, tp.fs_weight, tp.sdf_weight,
                         sdf_bias=bias_ray[:, None], gt_norm=dnorm)
    return loss, out


def track_frame(map_state: MapState, map_cfg: MapConfig, rc: RaycastConfig, tp: TrackParams,
                decoder_params, init_pose, points, points_cos, points_valid, learning_rate,
                generator: torch.Generator | None = None, sdf_bias=None,
                dec_meta: DecoderMeta = PLAIN) -> TrackResult:
    """Adam pose tracking on the sdf losses (nerfloam_tpu/core/tracking.py:
    383-497): one ray draw and one K9a march at ``init_pose`` (with
    ``tp.resample_rays``: a draw and a march at the current pose every
    iteration), then per iteration ``adam_loss`` at the current pose, its
    pose gradient by autograd and ``pose - learning_rate *
    scale_by_adam(g)``. The grid sampler is used whatever ``rc.sampler``
    says (JAX: tracking.py:410-416). A frame whose last iteration hit
    nothing keeps ``init_pose``, decided on the device."""
    dev = points.device

    def rays_at(pose6):
        """A fresh ray draw and its placer, marched at pose6."""
        ridx, rvalid = sample_ray_indices(points_valid, tp.n_rays, generator)
        pts, pcos = points[ridx], points_cos[ridx]
        rp = ray_prep(pts, pcos, tp.truncation, tp.max_depth)
        wdirs0 = se3.rotate_dirs(pose6, rp.dirs)
        placer = CdfPlacer.march(map_state, map_cfg, rc,
                                 se3.pose_translation(pose6).expand_as(wdirs0), wdirs0, rp.t_cap,
                                 rc.n_samples)
        return pts, pcos, rp.dirs, rp.dnorm, rvalid, placer, _bias_ray(pcos, sdf_bias, dev)

    if not tp.resample_rays:
        fixed = rays_at(init_pose)
    field = ActiveField(map_state, map_cfg)

    pose6 = init_pose.detach().clone()
    mu, nu = torch.zeros_like(pose6), torch.zeros_like(pose6)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for it in range(tp.num_iterations):
        pts, pcos, dirs, dnorm, rvalid, placer, bias_ray = (rays_at(pose6) if tp.resample_rays
                                                            else fixed)
        u = uniform_jitter((tp.n_rays, rc.n_samples), generator, dev)
        ub = (torch.rand((tp.n_rays, tp.band_samples), generator=generator, device=dev)
              if tp.band_samples else None)
        with torch.enable_grad():
            p = pose6.requires_grad_(True)
            loss, out = adam_loss(field, tp, decoder_params, p, dirs, pts, dnorm, pcos, rvalid,
                                  placer, u, ub, bias_ray, dec_meta)
            (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            pose6 = pose6.detach() - learning_rate * scale_by_adam_(g, mu, nu, it + 1)
        hits = out.ray_mask.sum()
    pose6 = torch.where(hits > 0, pose6, init_pose)
    return TrackResult(pose6, hits, loss.detach())
