"""Port parity: the GN tracker. One iteration's 6x6 normal equations (H, b)
against the same system rebuilt in JAX from sample_from_hits(u=...),
resolve_cells_in_hits, select_rows and field_from_embs under jax.grad, at
1e-4 relative to each array's largest entry; and the port's track_frame_gn
recovering a perturbed pose on a field trained by the port's own BA (the
contract of tests/test_render_track.py::test_tracking_gn_recovers_pose)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nerfloam_tpu.core import render as jrender
from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import raycast as jrc
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.models.decoder import init_decoder as t_init_decoder
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    hit_table_from_numpy,
    map_state_from_numpy,
    to_numpy,
)
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

torch.set_num_threads(2)
RCH = RC._replace(sampler="hits", max_hits=20)
T_RC = RaycastConfig(**RCH._asdict())
T_CFG = MapConfig(capacity=MAP_CFG.capacity, grid_dim=MAP_CFG.grid_dim, voxel_size=MAP_CFG.voxel_size)
TP = ttr.TrackParams(n_rays=512, num_iterations=4, truncation=0.5, max_depth=MAX_DEPTH,
                     fs_weight=1.0, sdf_weight=1000.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(to_numpy(got).astype(np.float64) - ref).max() / np.abs(ref).max()


def test_gn_normal_equations_match_jax(scene):
    _, frames = scene
    m = build_map(frames)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    params, meta = init_decoder(jax.random.key(2))
    pts, cos, T = frames[2]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::5][:256]
    p, c = p[idx], c[idx]
    dirs = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    init6 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    d0 = jse3.rotate_dirs(init6, dirs)
    ht0 = jrc.build_hit_table(m, MAP_CFG, RCH, jnp.broadcast_to(init6[:3], d0.shape), d0,
                              jtr.t_cap_for(p, c, TP.truncation, MAX_DEPTH))
    rvalid = jnp.asarray(rng.uniform(size=len(idx)) > 0.05)
    M = RCH.n_samples
    u = rng.uniform(1e-4, 1 - 1e-4, size=(len(idx), M)).astype(np.float32)
    pose6 = init6 + jnp.asarray([0.03, -0.02, 0.01, 0.002, -0.001, 0.004], jnp.float32)

    # JAX: the body of tracking.py:246-315 with u fed in
    vs = MAP_CFG.voxel_size
    wdirs = jse3.rotate_dirs(pose6, dirs)
    t_pos = pose6[:3]
    z, _, _, vmask, _ = jrc.sample_from_hits(ht0, M, None, u=jnp.asarray(u))
    xyz = t_pos[None, None, :] + wdirs[:, None, :] * z[..., None]
    onehot, _, found = jrc.resolve_cells_in_hits(ht0, jnp.floor(xyz / vs).astype(jnp.int32))
    vmask = vmask & found & rvalid[:, None]
    embs = jrender.select_rows(onehot, jrender.hit_rows(m, ht0))

    def field(x):
        return jrender.field_from_embs(MAP_CFG, params, meta, x, embs)

    sdf = field(xyz)
    g = jax.grad(lambda x: jnp.sum(field(x)))(xyz)
    T_ = TP.truncation
    pcos = c
    d_meas = jnp.linalg.norm(p, axis=-1) * pcos
    depth_ok = (d_meas > 0) & (d_meas < MAX_DEPTH)
    zc = z * pcos[:, None]
    dd = d_meas[:, None]
    front = (zc < dd - T_) & vmask
    band = vmask & ~front & ~(zc > dd + T_) & depth_ok[:, None]
    nf, ns = jnp.sum(front), jnp.sum(band)
    tot = jnp.maximum(nf + ns, 1).astype(jnp.float32)
    r = jnp.where(front, sdf - 1.0, (zc + sdf * T_) - dd)
    w = jnp.where(front, TP.fs_weight * (1 - nf / tot), TP.sdf_weight * (1 - ns / tot)) * (front | band)
    gj = g * jnp.where(front, 1.0, T_)[..., None]
    J = jnp.concatenate([gj, jnp.cross(xyz - t_pos, gj)], -1)
    H = jnp.einsum("nmi,nmj->ij", J * w[..., None], J, precision=jax.lax.Precision.HIGHEST)
    b = jnp.einsum("nmi,nm->i", J * w[..., None], r, precision=jax.lax.Precision.HIGHEST)

    # port: K1 -> decoder fwd/bwd -> K2 (plain twins on the CPU) -> gn_system
    tpose = _t(pose6)
    twd = _t(wdirs)
    tht = hit_table_from_numpy(jax.device_get(ht0))
    tpacked = _t(m.packed)
    tparams = decoder_params_from_jax(jax.device_get(params))
    tz, tvalid, taid, txyz, tfeats = trender.hits_field_fwd(tht, _t(u), tpose[:3].expand_as(twd),
                                                            twd, tpacked, vs)
    tsdf, tg = ttr.field_and_grad(tparams, tfeats, txyz, taid, tvalid, tpacked, vs, torch.float32)
    tp, tc = _t(p), _t(c)
    tdm = torch.linalg.norm(tp, dim=-1) * tc
    tH, tb, tloss = ttr.gn_system(txyz, tpose[:3], tz, tsdf, tg, tvalid & _t(rvalid)[:, None], tc,
                                  tdm, (tdm > 0) & (tdm < MAX_DEPTH), TP)
    np.testing.assert_array_equal(to_numpy(tvalid & _t(rvalid)[:, None]), np.asarray(vmask))
    assert _rel_err(tH, H) <= 1e-4
    assert _rel_err(tb, b) <= 1e-4
    np.testing.assert_allclose(float(tloss), float(jnp.sum(w * r * r)), rtol=1e-4)
    new = ttr.lm_update(tpose, tH, tb, 1e-2)
    assert torch.isfinite(new).all() and float((new - tpose).abs().max()) <= 0.5


def test_track_frame_gn_recovers_pose(scene):
    _, frames = scene
    tm = map_state_from_numpy(jax.device_get(build_map(frames)))
    gen = torch.Generator().manual_seed(0)
    params = t_init_decoder(width=64, generator=gen)
    bp = tba.BAParams(n_frames=4, n_rays=192, num_iterations=150, truncation=0.5,
                      max_depth=MAX_DEPTH, fs_weight=1.0, sdf_weight=1000.0)
    P, C, V, poses = [], [], [], []
    for pts, cos, T in frames[:4]:
        p, c, v = pad_frame(pts, cos)
        P.append(_t(p)), C.append(_t(c)), V.append(_t(v))
        poses.append(np.asarray(jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))))
    res = tba.ba_step(tm, T_CFG, T_RC, bp, params, _t(np.stack(poses)), torch.stack(P),
                      torch.stack(C), torch.stack(V), torch.ones(4, dtype=torch.bool),
                      torch.zeros(4, dtype=torch.bool), True, [0.05, 0.005, 0.0], gen)
    tm = tm._replace(embeddings=res.embeddings, packed=res.packed)
    assert int(res.touched_count) > 0

    pts, cos, T = frames[4]
    p, c, v = pad_frame(pts, cos)
    gt6 = _t(jse3.pose_from_matrix(jnp.asarray(T, jnp.float32)))
    init6 = gt6 + torch.tensor([0.15, -0.12, 0.0, 0.0, 0.0, 0.02])
    out = ttr.track_frame_gn(tm, T_CFG, T_RC, TP, res.decoder_params, init6, _t(p), _t(c), _t(v),
                             gen)
    err_before = float(torch.linalg.norm(init6[:3] - gt6[:3]))
    err_after = float(torch.linalg.norm(out.pose[:3] - gt6[:3]))
    assert int(out.hit_count) > 100
    assert err_after < err_before * 0.6, (err_before, err_after)


def test_ba_step_freezes_and_projects_pose(scene):
    """BA pose updates: a frozen frame does not move, and ``proj_dir``
    removes that direction from the free frame's translation update
    (ba.py:349-369, as test_pipeline.py's ba_pose_project test checks)."""
    _, frames = scene
    tm = map_state_from_numpy(jax.device_get(build_map(frames)))
    gen = torch.Generator().manual_seed(1)
    params = t_init_decoder(width=32, generator=gen)
    bp = tba.BAParams(n_frames=2, n_rays=128, num_iterations=3, truncation=0.5,
                      max_depth=MAX_DEPTH, fs_weight=1.0, sdf_weight=1000.0, touched_cap=64)
    P, C, V, poses = [], [], [], []
    for pts, cos, T in frames[:2]:
        p, c, v = pad_frame(pts, cos)
        P.append(_t(p)), C.append(_t(c)), V.append(_t(v))
        poses.append(np.asarray(jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))))
    poses = _t(np.stack(poses))
    proj = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    res = tba.ba_step(tm, T_CFG, T_RC, bp, params, poses, torch.stack(P), torch.stack(C),
                      torch.stack(V), torch.ones(2, dtype=torch.bool),
                      torch.tensor([False, True]), False, [0.05, 0.005, 0.01], gen,
                      proj_dir=proj)
    moved = res.poses - poses
    assert torch.equal(moved[0], torch.zeros(6))
    assert float(moved[1, 0].abs()) < 1e-6
    assert float(moved[1, 1:3].abs().max()) > 1e-4
    for w_new, w_old in zip(res.decoder_params["w"], params["w"]):  # decoder frozen
        assert torch.equal(w_new, w_old)
    # the touched count overflowed its cap of 64: reconcile folded a
    # truncated set, which the pipeline detects and replays
    assert int(res.touched_count) > 64
