"""Windowed bundle adjustment on the superset + hits path (port of
nerfloam_tpu/core/ba.py:55-113, 128-417, 476-500, single device).

One call = one BA step: a 2x ray superset per frame is drawn and its hit
table built once (K4); every iteration trains on a random subset of it
through K1/K2 (core/render.render_rays_hits) and takes an Adam step on the
packed corner table, the decoder and the poses. Adam follows
``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
bias-corrected) with fresh state per call, applied as ``p - lr * u``.
Frozen groups have their gradients zeroed before Adam, which with fresh
state equals leaving them out. After the loop the touched voxels' deltas
are folded back into the canonical embeddings (reconcile_packed, mean) and
the packed table is rebuilt from them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfloam_tpu_torch.core.losses import sdf_losses
from nerfloam_tpu_torch.core.render import render_rays_hits
from nerfloam_tpu_torch.core.tracking import _ray_dirs, t_cap_for
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.raycast import (
    RaycastConfig,
    build_hit_table,
    pack_hit_table,
    uniform_jitter,
    unpack_hit_table,
)
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class BAParams(NamedTuple):
    n_frames: int
    n_rays: int
    num_iterations: int
    truncation: float
    max_depth: float
    fs_weight: float
    sdf_weight: float
    compute_dtype: str = "float32"
    touched_cap: int = 1 << 16
    ray_superset: int = 2


class BAResult(NamedTuple):
    embeddings: torch.Tensor   # (C, F) reconciled canonical table
    packed: torch.Tensor       # (A, 8F) repacked from it
    decoder_params: dict
    poses: torch.Tensor        # (W, 6)
    loss: torch.Tensor
    touched_count: torch.Tensor  # () voxels touched this step
    upd_count: torch.Tensor    # (C,)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (W, K, ...) gathered along dim 1 by idx (W, N)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def ba_step(map_state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig, bp: BAParams,
            decoder_params, poses, points, points_cos, points_valid, frame_active, pose_free,
            update_decoder: bool, lrs, generator: torch.Generator | None = None,
            proj_dir=None) -> BAResult:
    """One BA step. ``poses`` (W, 6), ``points`` (W, P, 3), ``points_cos``
    and ``points_valid`` (W, P), ``frame_active`` / ``pose_free`` (W,) bool,
    ``lrs`` [emb, decoder, pose]. ``proj_dir`` (W, 3): remove that
    component from each frame's translation update every iteration."""
    if rc.sampler != "hits" or bp.ray_superset <= 0:
        raise NotImplementedError(
            "BA without the hits sampler and a ray superset is not ported yet "
            "(ROADMAP queue 1, items 11 and 15)")
    dev = points.device
    compute_dtype = getattr(torch, bp.compute_dtype)
    W, N, M = bp.n_frames, bp.n_rays, rc.n_samples
    K = N * bp.ray_superset
    vs = map_cfg.voxel_size

    with torch.no_grad():
        sidx, svalid = sample_ray_indices(points_valid, K, generator)
        sup_pts = _gather_rows(points, sidx)
        sup_cos = _gather_rows(points_cos, sidx)
        sup_dirs = _ray_dirs(sup_pts)
        sup_tcap = t_cap_for(sup_pts, sup_cos, bp.truncation, bp.max_depth)
        wdirs0 = se3.rotate_dirs(poses, sup_dirs)
        origins0 = se3.pose_translation(poses)[:, None, :].expand_as(wdirs0)
        ht_sup = build_hit_table(map_state, map_cfg, rc, origins0.reshape(W * K, 3),
                                 wdirs0.reshape(W * K, 3), sup_tcap.reshape(W * K))
        sup_hits = pack_hit_table(ht_sup).reshape(W, K, -1)

    emb = map_state.packed.clone().requires_grad_(True)
    dec = {k: [p.detach().clone().requires_grad_(True) for p in v]
           for k, v in decoder_params.items()}
    pos = poses.detach().clone().requires_grad_(True)
    params = [emb, *dec["w"], *dec["b"], pos]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    lr_of = [lrs[0]] + [lrs[1]] * (len(params) - 2) + [lrs[2]]
    pose_mask = (pose_free & frame_active).to(torch.float32)[:, None]
    dec_mask = 1.0 if update_decoder else 0.0
    touched = torch.zeros((map_state.packed.shape[0],), dtype=torch.bool, device=dev)
    loss = torch.zeros((), device=dev)

    for it in range(bp.num_iterations):
        ridx = torch.randint(0, K, (W, N), generator=generator, device=dev)
        rvalid = torch.gather(svalid, 1, ridx) & frame_active[:, None]
        u = uniform_jitter((W * N, M), generator, dev)

        pts = _gather_rows(sup_pts, ridx).reshape(W * N, 3)
        pcos = _gather_rows(sup_cos, ridx).reshape(W * N)
        dirs = _gather_rows(sup_dirs, ridx)
        ht = unpack_hit_table(_gather_rows(sup_hits, ridx).reshape(W * N, -1))
        wdirs = se3.rotate_dirs(pos, dirs)
        origins = se3.pose_translation(pos)[:, None, :].expand_as(wdirs)
        out = render_rays_hits(emb, dec, vs, origins.reshape(W * N, 3), wdirs.reshape(W * N, 3),
                               ht, rvalid.reshape(W * N), u, compute_dtype)
        loss, _ = sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, pts, pcos,
                             bp.truncation, bp.max_depth, bp.fs_weight, bp.sdf_weight)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

        with torch.no_grad():
            touched |= (grads[0] != 0.0).any(-1)
            for i in range(1, len(params) - 1):
                grads[i] = grads[i] * dec_mask
            grads[-1] = grads[-1] * pose_mask
            t = it + 1
            for i, (p, g) in enumerate(zip(params, grads)):
                mu[i].mul_(_B1).add_(g, alpha=1.0 - _B1)
                nu[i].mul_(_B2).addcmul_(g, g, value=1.0 - _B2)
                upd = (mu[i] / (1.0 - _B1 ** t)) / (torch.sqrt(nu[i] / (1.0 - _B2 ** t)) + _EPS)
                if i == len(params) - 1:
                    if proj_dir is not None:
                        u_t = upd[:, :3]
                        u_t = u_t - proj_dir * torch.sum(u_t * proj_dir, -1, keepdim=True)
                        upd = torch.cat([u_t, upd[:, 3:]], 1)
                    upd = upd * pose_mask
                p.sub_(lr_of[i] * upd)

    with torch.no_grad():
        touched_count = touched.sum(dtype=torch.int32)
        upd_count = vm.bump_upd_count(map_state, map_cfg, touched)
        new_emb = vm.reconcile_packed(map_state, map_cfg, emb.detach(), touched, bp.touched_cap)
        packed = vm.pack_embeddings(map_state._replace(embeddings=new_emb), map_cfg)
    new_dec = {k: [p.detach() for p in v] for k, v in dec.items()}
    return BAResult(new_emb, packed, new_dec, pos.detach(), loss.detach(), touched_count,
                    upd_count)
