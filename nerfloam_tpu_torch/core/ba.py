"""Windowed bundle adjustment on a ray superset (port of
nerfloam_tpu/core/ba.py:55-113, 128-417, 476-500, single device).

One call = one BA step: a 2x ray superset per frame is drawn (its keys in
one launch, ``sampling.draw_indices``), its points, directions, ranges and
lengths taken in one more (``tracking.ray_superset``: one 32 B row a ray,
from which every iteration's ``tracking.ray_pick`` takes its rays in one
launch) and, once per
step, its hit table built (K4, hits sampler, packed into one row a ray by
the launch) or its occupancy cdf marched (K9a, grid sampler, launched as
part of making K9b's CdfPlacer, ``CdfPlacer.march``); every iteration
trains on a random subset of it through K1 (hits) or K9b + K8 (grid, each
ray reading its superset row of the cdf), with K8's band/anchor columns when
the quality stack is on, and K2 in the backward (core/render
render_rays_hits / render_rays), and takes an Adam step on the packed
corner table, the decoder and the poses. Adam follows
``optax.scale_by_adam`` (tracking.scale_by_adam_) with fresh state per
call, applied as ``p - lr * u``. Frozen groups have their gradients zeroed
before Adam, which with fresh state equals leaving them out. After the
loop K5 (voxel_map.reconcile, through the caller's ``ReconcileScratch``)
folds the touched voxels' deltas back into the canonical embeddings
(``bp.reconcile_mode``: mean or sum), bumps their update counts and
repacks the table from them. With ``measure_bias`` the final field is
probed at the window's measured points (K8 then the decoder):
``surface_bias`` is its mean there, the offset the pipeline's bias
transfer feeds to the next tracked frame.

The reference-exact fallbacks (JAX ba.py:167-172, 222-227, 245-250,
312-314, 346-347, 380-391):
- ``ray_superset=0``: no superset; every iteration draws ``n_rays`` rays a
  frame over all the frame's points (``tracking.ray_draw``, the frame mask
  in it) and marches them at the current poses (a ``CdfPlacer.march``,
  K9a), always on the grid sampler;
- ``exact_embedding_grads`` (which implies the above): the Adam parameter
  is the canonical (C, F) f32 table, repacked every iteration inside the
  differentiated function by E1 (``voxel_map.PackEmbeddings``: the pack
  pass forward, csrc/pack_grad.cu backward, its lists built once a step
  into the caller's ``PackGradScratch``); no voxel is marked touched, so
  no K5 runs and the update counts stay as they were; after the loop E1's
  forward repacks the table once more.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from nerfloam_tpu_torch.core.losses import sdf_losses
from nerfloam_tpu_torch.core.render import (
    ActiveField,
    DpackedScratch,
    extra_surface_z,
    field_at_points,
    render_rays,
    render_rays_hits,
)
from nerfloam_tpu_torch.core.tracking import (
    ray_draw,
    ray_pick,
    ray_superset,
    scale_by_adam_,
)
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.models.decoder import PLAIN, DecoderMeta, decoder_leaves, map_decoder
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.ieee import norm3
from nerfloam_tpu_torch.ops.raycast import (
    CdfPlacer,
    RaycastConfig,
    build_hit_table_packed,
    uniform_jitter,
    unpack_hit_table,
)
from nerfloam_tpu_torch.ops.sampling import draw_indices
from nerfloam_tpu_torch.parallel.sharding import all_reduce_sum, dp_cols


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
    surface_anchor: int = 0  # anchor columns at the measured point (its weight)
    band_samples: int = 0    # stratified columns across the truncation band
    measure_bias: bool = True  # probe the final field (BAResult.surface_bias)
    exact_embedding_grads: bool = False  # the canonical table as the parameter
    reconcile_mode: str = "mean"  # K5's shared-corner combining: "mean" | "sum"


class BAResult(NamedTuple):
    embeddings: torch.Tensor   # (C, F) reconciled canonical table
    packed: torch.Tensor       # (A, 8F) repacked from it
    decoder_params: dict
    poses: torch.Tensor        # (W, 6)
    loss: torch.Tensor
    touched_count: torch.Tensor  # () voxels touched this step
    surface_bias: torch.Tensor  # () mean sdf of the final field at the
    #   active frames' measured points (0 unless bp.measure_bias)
    upd_count: torch.Tensor    # (C,)


def ba_step(map_state: vm.MapState, map_cfg: vm.MapConfig, rc: RaycastConfig, bp: BAParams,
            decoder_params, poses, points, points_cos, points_valid, frame_active, pose_free,
            update_decoder: bool, lrs, generator: torch.Generator | None = None,
            proj_dir=None, reconcile_scratch: vm.ReconcileScratch | None = None,
            pack_scratch: vm.PackGradScratch | None = None,
            dec_meta: DecoderMeta = PLAIN, group=None) -> BAResult:
    """One BA step. ``poses`` (W, 6), ``points`` (W, P, 3), ``points_cos``
    and ``points_valid`` (W, P), ``frame_active`` / ``pose_free`` (W,) bool,
    ``lrs`` [emb, decoder, pose]. ``proj_dir`` (W, 3): remove that
    component from each frame's translation update every iteration.
    ``reconcile_scratch``: K5's scratch, ``pack_scratch``: E1's (exact
    gradients), each kept by the caller from step to step (the
    pipeline's; None: one made for this step). ``dec_meta``: the decoder's
    skips and embedder; every decoder tensor (``decoder_leaves``, the
    gaussian embedder's B too) takes the decoder's learning rate, mask and
    Adam step, as JAX's optax step over the decoder pytree.

    ``group``: a ``torch.distributed`` group of dp ranks (JAX's sharded
    step, ba.py:115-126, 308, 336-344). Every rank draws the same global
    rays, jitter and band draws and trains on its block of n_rays / dp
    columns (``dp_cols``); the superset, its hit table or march, and the
    map, decoder, poses and Adam state are replicated. ``sdf_losses`` takes
    the global counts; after the backward one all-reduce (SUM) of every
    gradient makes the global gradient on every rank (torch's backward of
    the local loss is already a partial sum: no divide by dp; the packed
    table's over the rows some rank touched, the others being 0 on every
    rank), from which ``touched`` is taken; Adam, reconcile and the repack then run alike on
    every rank. The loss returned is the ranks' sum. None: one device."""
    if rc.sampler not in ("hits", "grid"):
        raise ValueError(f"unknown sampler {rc.sampler!r}")
    exact = bp.exact_embedding_grads
    if exact and map_state.embeddings.dtype != torch.float32:
        raise ValueError(f"exact_embedding_grads needs float32 embeddings, got "
                         f"{map_state.embeddings.dtype}")
    use_superset = bp.ray_superset > 0 and not exact
    use_hits = use_superset and rc.sampler == "hits"
    dev = points.device
    compute_dtype = getattr(torch, bp.compute_dtype)
    W, N, M = bp.n_frames, bp.n_rays, rc.n_samples
    K = N * bp.ray_superset
    cols = dp_cols(group, N)  # this rank's columns of a global (W, N, ...) draw
    Nl = cols.stop - cols.start
    vs = map_cfg.voxel_size
    frame = torch.arange(W, device=dev)[:, None]  # x[frame, idx]: x (W, K, ...) by idx (W, N)

    if use_superset:
        with torch.no_grad():
            sup = ray_superset(draw_indices(points_valid, K, generator), points, points_cos,
                               points_valid, bp.truncation, bp.max_depth)
            sup_args = (map_state, map_cfg, rc, *se3.pose_rays(poses, sup.dirs),
                        sup.t_cap.reshape(W * K))
            if use_hits:
                sup_hits = build_hit_table_packed(*sup_args).reshape(W, K, -1)
            else:  # K9a once, into the placer that packs K9b's fixed arguments once; rows
                # pick each ray's cdf row
                placer = CdfPlacer.march(*sup_args, M, W * Nl)

    if exact:  # the canonical table, repacked by E1 every iteration
        pack_scratch = (vm.PackGradScratch() if pack_scratch is None
                        else pack_scratch).build(map_state, map_cfg)
        emb = map_state.embeddings.detach().clone().requires_grad_(True)
    else:
        emb = map_state.packed.clone().requires_grad_(True)
    dec = map_decoder(decoder_params, lambda p: p.detach().clone().requires_grad_(True))
    pos = poses.detach().clone().requires_grad_(True)
    params = [emb, *decoder_leaves(dec), pos]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    lr_of = [lrs[0]] + [lrs[1]] * (len(params) - 2) + [lrs[2]]
    pose_mask = (pose_free & frame_active).to(torch.float32)[:, None]
    dec_mask = 1.0 if update_decoder else 0.0
    touched = torch.zeros((map_state.packed.shape[0],), dtype=torch.bool, device=dev)
    loss = torch.zeros((), device=dev)
    k2_scratch = DpackedScratch()  # K2's d-packed scratch, the step's calls in turn
    field = ActiveField(map_state, map_cfg)  # K8's grid, checked once a step

    for it in range(bp.num_iterations):
        if use_superset:  # a pick from the superset: one launch
            ridx = torch.randint(0, K, (W, N), generator=generator, device=dev)
            rvalid, pts, pcos, dirs, dnorm, rows = ray_pick(ridx, cols, sup, frame_active)
        else:  # a fresh draw over all the frame's points, its setup in one launch
            rd = ray_draw(draw_indices(points_valid, N, generator), cols, points, points_cos,
                          points_valid, bp.truncation, bp.max_depth, frame_active=frame_active)
            rvalid, dirs, t_cap = rd.rvalid.reshape(W * Nl), rd.dirs, rd.t_cap
            pts, pcos, dnorm = (rd.pts.reshape(W * Nl, 3), rd.pcos.reshape(W * Nl),
                                rd.dnorm.reshape(W * Nl))
        u = uniform_jitter((W * N, M), generator, dev)
        if group is not None:
            u = u.view(W, N, M)[:, cols].reshape(W * Nl, M)

        rays = se3.pose_rays(pos, dirs)  # (origins, wdirs), (W * Nl, 3) rows
        extra = None
        if bp.surface_anchor or bp.band_samples:
            ub = (torch.rand((W, N, bp.band_samples), generator=generator,
                             device=dev)[:, cols].reshape(W * Nl, -1) if bp.band_samples else None)
            ez = extra_surface_z(dnorm, pcos, bp.truncation, bp.surface_anchor, bp.band_samples,
                                 ub)
            extra = (field, ez, rvalid)
        packed = vm.PackEmbeddings.apply(emb, map_state, map_cfg, pack_scratch) if exact else emb
        if use_hits:
            ht = unpack_hit_table(sup_hits[frame, ridx[:, cols]].reshape(W * Nl, -1))
            out = render_rays_hits(packed, dec, vs, *rays, ht, rvalid, u, compute_dtype, extra,
                                   k2_scratch, dec_meta)
        else:
            if not use_superset:  # K9a at the current poses, into this iteration's placer
                rows = None
                with torch.no_grad():
                    placer = CdfPlacer.march(map_state, map_cfg, rc, rays[0].detach(),
                                             rays[1].detach(), t_cap.reshape(W * Nl), M)
            out = render_rays(packed, dec, field, *rays, rvalid, placer, u, compute_dtype, extra,
                              rows, k2_scratch, dec_meta)
        loss, _ = sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, pts, pcos,
                             bp.truncation, bp.max_depth, bp.fs_weight, bp.sdf_weight,
                             gt_norm=dnorm, group=group)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if group is not None:
            grads = all_reduce_sum(grads, group)

        with torch.no_grad():
            if not exact:
                touched |= (grads[0] != 0.0).any(-1)
            for i in range(1, len(params) - 1):
                grads[i] = grads[i] * dec_mask
            grads[-1] = grads[-1] * pose_mask
            for i, (p, g) in enumerate(zip(params, grads)):
                upd = scale_by_adam_(g, mu[i], nu[i], it + 1)
                if i == len(params) - 1:
                    if proj_dir is not None:
                        u_t = upd[:, :3]
                        u_t = u_t - proj_dir * torch.sum(u_t * proj_dir, -1, keepdim=True)
                        upd = torch.cat([u_t, upd[:, 3:]], 1)
                    upd = upd * pose_mask
                p.sub_(lr_of[i] * upd)

    with torch.no_grad():
        if exact:  # no voxel touched: no reconcile, the counts as they were
            new_emb = emb.detach()
            packed = vm.pack_embeddings_fwd(map_state, map_cfg, new_emb)
            upd_count = map_state.upd_count
            touched_count = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            new_emb, packed, upd_count, touched_count = vm.reconcile(
                map_state, map_cfg, emb.detach(), touched, bp.touched_cap, reconcile_scratch,
                bp.reconcile_mode)
    new_dec = map_decoder(dec, torch.Tensor.detach)
    loss = loss.detach()
    if group is not None:
        dist.all_reduce(loss, group=group)
    surface_bias = torch.zeros((), device=dev)
    if bp.measure_bias:  # ba.py:398-413, on the reconciled field
        with torch.no_grad():
            xyz = se3.transform_points(pos.detach(), points)             # (W, P, 3)
            depth = norm3(points)
            ok = points_valid & frame_active[:, None] & (depth < bp.max_depth)
            sdf_pts, m = field_at_points(field, packed, new_dec,
                                         xyz.reshape(-1, 1, 3), depth.reshape(-1, 1),
                                         ok.reshape(-1), compute_dtype, dec_meta)
            surface_bias = sdf_pts.sum() / torch.clamp(m.sum(), min=1).to(torch.float32)
    return BAResult(new_emb, packed, new_dec, pos.detach(), loss, touched_count,
                    surface_bias, upd_count)


@torch.no_grad()
def surface_bias_at(map_state: vm.MapState, map_cfg: vm.MapConfig, decoder_params, dec_meta,
                    pose6, points, points_valid, max_depth: float,
                    compute_dtype=torch.float32, points_cos=None) -> torch.Tensor:
    """The settled-bias probe (JAX ba.py:420-477, ``tpu_specs.bias_source=
    keyframe``): the field's mean value at one frame's measured points
    (P, 3) under ``pose6``, per class. A point counts where it is valid, in
    an active voxel and at a depth in (0, max_depth); ground where its
    cosine is under 0.999 (no cosines: no ground). K8 in its given-points
    form reads the packed rows (one launch on the card), then the decoder.
    Returns (2, 2) f32: [ground mean, non-ground mean], then the two
    counts (a mean over max(count, 1))."""
    xyz = se3.transform_points(pose6, points)
    depth = norm3(points)
    ok = points_valid & (depth > 0) & (depth < max_depth)
    sdf, m = field_at_points(ActiveField(map_state, map_cfg), map_state.packed, decoder_params,
                             xyz.reshape(-1, 1, 3), depth.reshape(-1, 1), ok, compute_dtype,
                             dec_meta)
    sdf, m = sdf[:, 0], m[:, 0]
    ground = (torch.zeros_like(m) if points_cos is None else points_cos < 0.999)
    out = []
    for cls in (m & ground, m & ~ground):
        c = cls.sum()
        s = torch.where(cls, sdf, 0.0).sum()
        out.append((s / torch.clamp(c, min=1).to(torch.float32), c.to(torch.float32)))
    (bg, cg), (bn, cn) = out
    return torch.stack([torch.stack([bg, bn]), torch.stack([cg, cn])])
