"""Port parity for the quality stack (support voxels, band/anchor columns,
bias transfer) against the JAX package, on the CPU. Inputs come from a
numpy seed and are handed to both sides; the band jitter is given, not
drawn. Tolerances:
- band/anchor depths exact, their sdf 1e-5 (f32 decoder, as in
  test_torch_render.py);
- one BA iteration's loss and gradients with band columns: loss 1e-5
  relative, each gradient 1e-4 of its largest entry (the slice-1 BA test);
- the surface-bias probe of a BA step: 1e-5;
- one GN iteration with band columns and a (2,) sdf_bias: H, b and loss
  1e-4 relative (the slice-1 GN test);
- insert_frame with symmetric support: equal counts, equal sets, and
  equal packed rows per voxel coordinate (JAX elects any duplicate, the
  port the smallest slot, so row ids differ);
- the bias EMA: equal in float32;
- a 10-frame quality slice on both sides: ATE under 0.30 m each and
  within 0.10 m of each other (random streams differ, as in
  test_torch_pipeline.py).
"""

import json
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfloam_tpu.core import ba as jba
from nerfloam_tpu.core import losses as jlosses
from nerfloam_tpu.core import render as jrender
from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.core.pipeline import NerfLoamSLAM
from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import raycast as jrc
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu.utils import evaluation as ev
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import losses as tlosses
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.map import voxel_map as tvm
from nerfloam_tpu_torch.models.decoder import decoder_apply
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    hit_table_from_numpy,
    map_config_from_jax,
    map_state_from_numpy,
    to_numpy,
)
from nerfloam_tpu_torch.utils.config import finalize, load_json_config
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
RCH = RC._replace(sampler="hits", max_hits=20)
T_RC = RaycastConfig(**RCH._asdict())
T_CFG = map_config_from_jax(MAP_CFG)
TRUNC, FS_W, SDF_W = 0.5, 1.0, 1e4
N_BAND, N_ANCHOR = 8, 1
QUALITY = ["tpu_specs.support_dist=-1", "tpu_specs.support_sym=true",
           "tpu_specs.band_samples=8", "tpu_specs.bias_correction=true"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(to_numpy(got).astype(np.float64) - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def setup(scene):
    """A trained-looking map (random embeddings), 192 rays of frame 1 with
    their hit table, and the jitters both sides take."""
    _, frames = scene
    m = build_map(frames)
    rng = np.random.default_rng(5)
    emb = rng.normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    params, meta = init_decoder(jax.random.key(3))
    pts, cos, T = frames[1]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::9][:192]
    p, c = p[idx], c[idx]
    dirs = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    pose6 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    d0 = jse3.rotate_dirs(pose6, dirs)
    ht = jrc.build_hit_table(m, MAP_CFG, RCH, jnp.broadcast_to(pose6[:3], d0.shape), d0,
                             jtr.t_cap_for(p, c, TRUNC, MAX_DEPTH))
    R = len(idx)
    return dict(
        m=m, tm=map_state_from_numpy(jax.device_get(m), device="cpu"), params=params, meta=meta,
        tparams=decoder_params_from_jax(jax.device_get(params), device="cpu"), p=p, c=c, dirs=dirs,
        ht=ht, tht=hit_table_from_numpy(jax.device_get(ht), device="cpu"),
        ray_valid=jnp.asarray(rng.uniform(size=R) > 0.05),
        u=rng.uniform(1e-4, 1 - 1e-4, size=(R, RCH.n_samples)).astype(np.float32),
        band_u=rng.uniform(size=(R, N_BAND)).astype(np.float32),
        pose=pose6 + jnp.asarray([0.02, -0.01, 0.0, 0.0, 0.0, 0.005], jnp.float32),
        frames=frames,
    )


def _rays(pose6, dirs, lib):
    """(origins, world directions) of the rays at pose6, in JAX or torch."""
    d = lib.rotate_dirs(pose6, dirs)
    t = lib.pose_translation(pose6)
    return (t.expand_as(d) if lib is tse3 else jnp.broadcast_to(t, d.shape)), d


@pytest.mark.parametrize("trunc", [0.5, 0.3])
def test_band_columns_match_jax(setup, trunc):
    """The band columns at the truncation (0.3: the shipped configs'; 0.5 is
    a power of two, where a reciprocal times it is the division): depths
    and validity bit-equal, sdf within 1e-5."""
    s = setup
    o, d = _rays(s["pose"], s["dirs"], jse3)
    dnorm = jnp.linalg.norm(s["p"], axis=-1)
    jz, jsdf, jvalid = jrender.extra_surface_columns(
        s["m"], MAP_CFG, s["params"], s["meta"], o, d, dnorm, s["c"], s["ray_valid"], trunc,
        N_ANCHOR, N_BAND, None, band_u=jnp.asarray(s["band_u"]))
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    ez = trender.extra_surface_z(_t(dnorm), _t(s["c"]), trunc, N_ANCHOR, N_BAND, _t(s["band_u"]))
    out = trender.render_rays_hits(s["tm"].packed, s["tparams"], MAP_CFG.voxel_size, to, td,
                                   s["tht"], _t(s["ray_valid"]), _t(s["u"]),
                                   extra=(trender.ActiveField(s["tm"], T_CFG), ez,
                                          _t(s["ray_valid"])))
    M = RCH.n_samples
    np.testing.assert_array_equal(to_numpy(out.valid_mask[:, M:]), np.asarray(jvalid))
    np.testing.assert_array_equal(to_numpy(out.z_vals[:, M:]), np.asarray(jz))
    np.testing.assert_allclose(to_numpy(out.sdf[:, M:]), np.asarray(jsdf), atol=1e-5)
    assert 0.2 < float(np.asarray(jvalid).mean()) < 1.0
    # an ActiveField made once (a tracker's frame), called twice with the
    # one origin expanded to every ray: the same columns as JAX's
    field = trender.ActiveField(s["tm"], T_CFG)
    for _ in range(2):
        _, evalid, _, efeats = field(s["tm"].packed, to, td, ez, _t(s["ray_valid"]))
        np.testing.assert_array_equal(to_numpy(evalid), np.asarray(jvalid))
        esdf = torch.where(evalid, decoder_apply(s["tparams"], efeats)[..., 0], 1.0)
        np.testing.assert_allclose(to_numpy(esdf), np.asarray(jsdf), atol=1e-5)
    # band depths alone: exact against band_sample_z
    np.testing.assert_array_equal(
        to_numpy(trender.band_sample_z(_t(dnorm), _t(s["c"]), trunc, N_BAND, _t(s["band_u"]))),
        np.asarray(jrender.band_sample_z(None, dnorm, s["c"], trunc, N_BAND,
                                         u=jnp.asarray(s["band_u"]))))


@pytest.mark.parametrize("trunc", [0.5, 0.3])
def test_t_cap_and_band_depths_match_jax(trunc):
    """The useful range (ray_prep_plain's t_cap against JAX's t_cap_for) and
    band_sample_z bit-equal to JAX's on 4,096 random rays (cosines in
    [0, 1], 8 band samples): truncation / cos is one IEEE division on both sides (at 0.3 torch's ``0.3 / x``, a reciprocal times
    0.3, moves dozens of rays by an ulp)."""
    rng = np.random.default_rng(12)
    p = rng.normal(size=(4096, 3)).astype(np.float32) * 10.0
    c = rng.uniform(0.0, 1.0, size=4096).astype(np.float32)
    u = rng.uniform(size=(4096, N_BAND)).astype(np.float32)
    d = np.linalg.norm(p, axis=-1).astype(np.float32)
    np.testing.assert_array_equal(
        to_numpy(ttr.ray_prep_plain(_t(p), _t(c), trunc, MAX_DEPTH).t_cap),
        np.asarray(jtr.t_cap_for(jnp.asarray(p), jnp.asarray(c), trunc, MAX_DEPTH)))
    np.testing.assert_array_equal(
        to_numpy(trender.band_sample_z(_t(d), _t(c), trunc, N_BAND, _t(u))),
        np.asarray(jrender.band_sample_z(None, jnp.asarray(d), jnp.asarray(c), trunc, N_BAND,
                                         u=jnp.asarray(u))))


def _j_loss(s, packed, params, pose6):
    o, d = _rays(pose6, s["dirs"], jse3)
    st = s["m"]._replace(packed=packed)
    out = jrender.render_rays_hits(st, MAP_CFG, RCH, params, s["meta"], o, d, s["ht"],
                                   s["ray_valid"], None, jitter_u=jnp.asarray(s["u"]))
    ez, esdf, eval_ = jrender.extra_surface_columns(
        st, MAP_CFG, params, s["meta"], o, d, jnp.linalg.norm(s["p"], axis=-1), s["c"],
        s["ray_valid"], TRUNC, 0, N_BAND, None, band_u=jnp.asarray(s["band_u"]))
    cat = lambda a, b: jnp.concatenate([a, b], axis=1)  # noqa: E731
    loss, _ = jlosses.sdf_losses(cat(out.z_vals, ez), cat(out.sdf, esdf),
                                 cat(out.valid_mask, eval_), out.ray_mask, s["p"], s["c"],
                                 TRUNC, MAX_DEPTH, FS_W, SDF_W)
    return loss


def test_ba_loss_gradients_with_band_columns_match_jax(setup):
    s = setup
    jl, jg = jax.value_and_grad(lambda *a: _j_loss(s, *a), argnums=(0, 1, 2))(
        s["m"].packed, s["params"], s["pose"])
    packed = _t(s["m"].packed).requires_grad_(True)
    params = decoder_params_from_jax(jax.device_get(s["params"]), device="cpu")
    flat = params["w"] + params["b"]
    for q in flat:
        q.requires_grad_(True)
    pose = _t(s["pose"]).requires_grad_(True)
    o, d = _rays(pose, _t(s["dirs"]), tse3)
    tp, tc, rv = _t(s["p"]), _t(s["c"]), _t(s["ray_valid"])
    ez = trender.extra_surface_z(torch.linalg.norm(tp, dim=-1), tc, TRUNC, 0, N_BAND,
                                 _t(s["band_u"]))
    out = trender.render_rays_hits(packed, params, MAP_CFG.voxel_size, o, d, s["tht"], rv,
                                   _t(s["u"]), extra=(trender.ActiveField(s["tm"], T_CFG), ez, rv))
    tl, _ = tlosses.sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, tp, tc, TRUNC,
                               MAX_DEPTH, FS_W, SDF_W, gt_norm=ieee.norm3(tp))
    grads = torch.autograd.grad(tl, [packed, *flat, pose])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jp, jd, jpose = jax.device_get(jg)
    jflat = [lay["w"] for lay in jd["layers"]] + [jd["out"]["w"]]
    jflat += [lay["b"] for lay in jd["layers"]] + [jd["out"]["b"]]
    pairs = [("packed", grads[0], jp)] + [
        (f"decoder[{i}]", g, r) for i, (g, r) in enumerate(zip(grads[1:-1], jflat))
    ] + [("pose", grads[-1], jpose)]
    for name, g, ref in pairs:
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        assert np.abs(to_numpy(g) - ref).max() <= 1e-4 * scale, name
    np.testing.assert_array_equal(to_numpy((grads[0] != 0).any(-1)), (np.asarray(jp) != 0).any(-1))


def test_surface_bias_probe_matches_jax(setup):
    """A BA step of zero iterations: the probe reads the repacked field at
    both frames' measured points under their poses (ba.py:393-415)."""
    s = setup
    frames = s["frames"][:2]
    P, C, V, poses = [], [], [], []
    for pts, cos, T in frames:
        p, c, v = pad_frame(pts, cos)
        P.append(p), C.append(c), V.append(v)
        poses.append(jse3.pose_from_matrix(jnp.asarray(T, jnp.float32)))
    P, C, V, poses = jnp.stack(P), jnp.stack(C), jnp.stack(V), jnp.stack(poses)
    active = jnp.asarray([True, False])
    kw = dict(n_frames=2, n_rays=64, num_iterations=0, truncation=TRUNC, max_depth=MAX_DEPTH,
              fs_weight=FS_W, sdf_weight=SDF_W, measure_bias=True)
    jres = jba.ba_step(s["m"], MAP_CFG, RCH, jba.BAParams(**kw), s["params"], s["meta"], poses,
                       P, C, V, active, jnp.zeros(2, bool), jnp.asarray(False),
                       jnp.asarray([0.01, 0.005, 0.0]), jax.random.key(0))
    tres = tba.ba_step(s["tm"], T_CFG, T_RC, tba.BAParams(**kw), s["tparams"], _t(poses), _t(P),
                       _t(C), _t(V), _t(active), torch.zeros(2, dtype=torch.bool), False,
                       [0.01, 0.005, 0.0], torch.Generator().manual_seed(0))
    assert abs(float(jres.surface_bias)) > 1e-3
    np.testing.assert_allclose(float(tres.surface_bias), float(jres.surface_bias), atol=1e-5)
    off = tba.ba_step(s["tm"], T_CFG, T_RC, tba.BAParams(**{**kw, "measure_bias": False}),
                      s["tparams"], _t(poses), _t(P), _t(C), _t(V), _t(active),
                      torch.zeros(2, dtype=torch.bool), False, [0.01, 0.005, 0.0],
                      torch.Generator().manual_seed(0))
    assert float(off.surface_bias) == 0.0


def test_gn_system_with_band_columns_and_bias_matches_jax(setup):
    s = setup
    m, vs, M = s["m"], MAP_CFG.voxel_size, RCH.n_samples
    tp = ttr.TrackParams(n_rays=192, num_iterations=1, truncation=TRUNC, max_depth=MAX_DEPTH,
                         fs_weight=1.0, sdf_weight=1000.0, surface_anchor=N_ANCHOR,
                         band_samples=N_BAND)
    sdf_bias = np.asarray([0.031, -0.017], np.float32)
    rvalid, pcos, p = s["ray_valid"], s["c"], s["p"]
    # JAX: the body of tracking.py:246-315 with u and the band jitter given
    pose6 = s["pose"]
    wdirs = jse3.rotate_dirs(pose6, s["dirs"])
    t_pos = pose6[:3]
    z, _, _, vmask, _ = jrc.sample_from_hits(s["ht"], M, None, u=jnp.asarray(s["u"]))
    xyz = t_pos[None, None, :] + wdirs[:, None, :] * z[..., None]
    onehot, _, found = jrc.resolve_cells_in_hits(s["ht"], jnp.floor(xyz / vs).astype(jnp.int32))
    vmask = vmask & found & rvalid[:, None]
    embs = jrender.select_rows(onehot, jrender.hit_rows(m, s["ht"]))
    dnorm = jnp.linalg.norm(p, axis=-1)
    ez = jnp.concatenate([jnp.repeat(dnorm[:, None], N_ANCHOR, axis=1),
                          jrender.band_sample_z(None, dnorm, pcos, TRUNC, N_BAND,
                                                u=jnp.asarray(s["band_u"]))], 1)
    exyz = t_pos[None, None, :] + wdirs[:, None, :] * ez[..., None]
    eaid = jvm.lookup_active(m, MAP_CFG, jnp.floor(exyz / vs).astype(jnp.int32))
    z = jnp.concatenate([z, ez], 1)
    vmask = jnp.concatenate([vmask, (eaid >= 0) & rvalid[:, None] & (ez > 0)], 1)
    embs = jnp.concatenate([embs, m.packed[jnp.clip(eaid, 0)]], 1)
    xyz = t_pos[None, None, :] + wdirs[:, None, :] * z[..., None]

    def field(x):
        return jrender.field_from_embs(MAP_CFG, s["params"], s["meta"], x, embs)

    sdf = field(xyz)
    g = jax.grad(lambda x: jnp.sum(field(x)))(xyz)
    T_ = TRUNC
    bias_ray = jnp.where(pcos < 0.999, sdf_bias[0], sdf_bias[1])
    d_meas = dnorm * pcos
    depth_ok = (d_meas > 0) & (d_meas < MAX_DEPTH)
    zc = z * pcos[:, None]
    dd = d_meas[:, None]
    front = (zc < dd - T_) & vmask
    band = vmask & ~front & ~(zc > dd + T_) & depth_ok[:, None]
    nf, ns = jnp.sum(front), jnp.sum(band)
    tot = jnp.maximum(nf + ns, 1).astype(jnp.float32)
    r = jnp.where(front, sdf - 1.0, (zc + (sdf - bias_ray[:, None]) * T_) - dd)
    w = jnp.where(front, tp.fs_weight * (1 - nf / tot), tp.sdf_weight * (1 - ns / tot))
    w = w * (front | band)
    gj = g * jnp.where(front, 1.0, T_)[..., None]
    J = jnp.concatenate([gj, jnp.cross(xyz - t_pos, gj)], -1)
    hp = jax.lax.Precision.HIGHEST
    H = jnp.einsum("nmi,nmj->ij", J * w[..., None], J, precision=hp)
    b = jnp.einsum("nmi,nm->i", J * w[..., None], r, precision=hp)
    assert float(jnp.sum(band[:, M:])) > 100

    # port: K1 + K8 columns -> decoder fwd/bwd -> one K2 -> K3 (plain twins)
    tpose, twd, tpts, tc, trv = _t(pose6), _t(wdirs), _t(p), _t(pcos), _t(rvalid)
    tdn = torch.linalg.norm(tpts, dim=-1)
    tez = trender.extra_surface_z(tdn, tc, TRUNC, N_ANCHOR, N_BAND, _t(s["band_u"]))
    tz, tvalid, taid, txyz, tfeats = trender.columns_fwd(
        s["tht"], _t(s["u"]), tpose[:3].expand_as(twd), twd, s["tm"].packed, vs,
        (trender.ActiveField(s["tm"], T_CFG), tez, trv))
    tsdf, tg = ttr.field_and_grad(s["tparams"], tfeats, txyz, taid, tvalid, s["tm"].packed, vs,
                                  torch.float32)
    tvm_ = tvalid & trv[:, None]
    tdm = tdn * tc
    tbias = torch.where(tc < 0.999, float(sdf_bias[0]), float(sdf_bias[1]))
    tH, tb, tloss = ttr.gn_system(txyz, tpose[:3], tz, tsdf, tg, tvm_, tc, tdm,
                                  (tdm > 0) & (tdm < MAX_DEPTH), tp, tbias)
    np.testing.assert_array_equal(to_numpy(tvm_), np.asarray(vmask))
    np.testing.assert_array_equal(to_numpy(tz), np.asarray(z))
    assert _rel_err(tH, H) <= 1e-4
    assert _rel_err(tb, b) <= 1e-4
    np.testing.assert_allclose(float(tloss), float(jnp.sum(w * r * r)), rtol=1e-4)
    # the tracker's form: a GnSystem made once for the frame, called twice
    system = ttr.GnSystem(tc, tdm, (tdm > 0) & (tdm < MAX_DEPTH), tbias, tp, tz.shape[1])
    for _ in range(2):
        sH, sb, sloss = system(txyz, tpose[:3], tz, tsdf, tg, tvm_)
        assert _rel_err(sH, H) <= 1e-4
        assert _rel_err(sb, b) <= 1e-4
        np.testing.assert_allclose(float(sloss), float(jnp.sum(w * r * r)), rtol=1e-4)


def _coords_rows(state):
    """(surface voxel coord -> corner coords, active coord -> packed row)."""
    sn = to_numpy(state) if hasattr(state.grid, "numpy") else jax.device_get(state)
    n = int(sn.num_lat)
    coords = np.asarray(sn.lat_coords)[:n]
    surf = np.nonzero(np.asarray(sn.is_surface)[:n])[0]
    corners = {tuple(coords[v]): frozenset(tuple(coords[c]) for c in np.asarray(sn.corner_idx)[v])
               for v in surf}
    na = min(int(sn.n_active), len(sn.active_ids))
    act = np.asarray(sn.active_coords)[:na]
    rows = {tuple(c): np.asarray(sn.packed)[i] for i, c in enumerate(act)}
    return set(map(tuple, coords)), corners, rows


def test_insert_frame_with_symmetric_support_matches_jax(scene):
    _, frames = scene
    jcfg = MAP_CFG._replace(support_dist=MAP_CFG.voxel_size, support_sym=True)
    tcfg = map_config_from_jax(jcfg)
    assert tcfg.support_dist == 0.5 and tcfg.support_sym
    # a first frame inserted and given embeddings keyed by coordinates, so
    # the appended voxels' packed rows hold nonzero shared corners
    j = jvm.recenter(jvm.create(jcfg), jcfg, jnp.zeros(3, jnp.float32))
    pts, cos, T = frames[0]
    p, c, v = pad_frame(pts, cos)
    pose0 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    j = jvm.insert_frame(j, jcfg, p, c, v, pose0)
    t = tvm.recenter(tvm.create(tcfg, "cpu"), tcfg, torch.zeros(3))
    t, _ = tvm.insert_frame(t, tcfg, _t(p), _t(c), _t(v), _t(pose0))
    lat_j, corners_j, _ = _coords_rows(j)
    lat_t, corners_t, _ = _coords_rows(t)
    assert int(j.num_lat) == int(t.num_lat) and lat_j == lat_t and corners_j == corners_t
    rng = np.random.default_rng(9)
    emb = {cc: rng.normal(size=16).astype(np.float32) for cc in lat_j}

    def with_emb(st, lib):
        sn = to_numpy(st) if lib == "t" else jax.device_get(st)
        e = np.zeros((jcfg.capacity, 16), np.float32)
        for i, cc in enumerate(np.asarray(sn.lat_coords)[: int(sn.num_lat)]):
            e[i] = emb[tuple(cc)]
        return st._replace(embeddings=jnp.asarray(e) if lib == "j" else torch.as_tensor(e))

    j = jvm.refresh_active(with_emb(j, "j"), jcfg)
    t = tvm.refresh_active(with_emb(t, "t"), tcfg)
    pts, cos, T = frames[2]
    p, c, v = pad_frame(pts, cos)
    pose2 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    j = jvm.insert_frame(j, jcfg, p, c, v, pose2, cand_cap=2048, append_active=True)
    t, _ = tvm.insert_frame(t, tcfg, _t(p), _t(c), _t(v), _t(pose2), 2048, append_active=True)
    assert int(j.num_cand) == int(t.num_cand) < 2048
    assert int(j.num_lat) == int(t.num_lat)
    assert int(j.n_active) == int(t.n_active)
    lat_j, corners_j, rows_j = _coords_rows(j)
    lat_t, corners_t, rows_t = _coords_rows(t)
    assert lat_j == lat_t and corners_j == corners_t
    assert rows_j.keys() == rows_t.keys()
    for cc in rows_j:
        np.testing.assert_array_equal(rows_t[cc], rows_j[cc])
    # support voxels: more surface than the measured points alone make
    plain, _ = tvm.insert_frame(tvm.recenter(tvm.create(T_CFG, "cpu"), T_CFG, torch.zeros(3)),
                                T_CFG, _t(p), _t(c), _t(v), _t(pose2))
    assert int(plain.is_surface.sum()) * 2 < int(t.is_surface.sum())


def test_bias_ema_matches_jax():
    seq = [0.02, float("nan"), -0.013, np.array([[0.05, 0.05], [1.0, 1.0]]),
           np.array([[0.01, 0.03], [3.0, 1.0]]), np.array([[0.4, 0.2], [0.0, 0.0]]), 0.007]
    fakes = {}
    for name, cls in (("jax", NerfLoamSLAM), ("port", NerfLoamSLAM_torch)):
        fakes[name] = types.SimpleNamespace(bias_correction=True, bias_classes=1,
                                            sdf_bias=np.zeros(2, np.float32),
                                            _pooled_bias=cls._pooled_bias)
    for sb in seq:
        NerfLoamSLAM._update_sdf_bias(fakes["jax"], sb)
        NerfLoamSLAM_torch._update_sdf_bias(fakes["port"], sb)
        np.testing.assert_array_equal(fakes["port"].sdf_bias, fakes["jax"].sdf_bias)
        assert fakes["port"].sdf_bias.dtype == np.float32
    assert fakes["port"].sdf_bias[0] != 0.0
    off = types.SimpleNamespace(bias_correction=False, sdf_bias=np.zeros(2, np.float32))
    NerfLoamSLAM_torch._update_sdf_bias(off, 0.5)
    assert off.sdf_bias[0] == 0.0


SLICE = CANON + [
    "data_specs.n_frames=10",
    "tpu_specs.bootstrap_steps=6",
    "tpu_specs.sampler=hits",
    "tpu_specs.track_method=gn",
    "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=false",
] + QUALITY


@pytest.fixture(scope="module")
def quality_runs():
    cfg = load_config(CFG_PATH, SLICE)
    ds = get_dataset(cfg)
    gt = ds.gt_trajectory()
    jslam = NerfLoamSLAM(cfg, ds)
    jax_poses = np.asarray(jslam.run())
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    port_poses = np.asarray(slam.run())
    return gt, jax_poses, port_poses, jslam, slam


def test_quality_slice_matches_jax(quality_runs):
    gt, jax_poses, port_poses, jslam, slam = quality_runs
    assert port_poses.shape == jax_poses.shape == (10, 4, 4)
    ate_jax = ev.ate_rmse(jax_poses, gt[:10], align=False)
    ate_port = ev.ate_rmse(port_poses, gt[:10], align=False)
    assert ate_jax < 0.30, ate_jax
    assert ate_port < 0.30, ate_port
    assert abs(ate_port - ate_jax) <= 0.10, (ate_port, ate_jax)
    # the quality stack ran: support voxels, a bias estimate, no drops
    assert slam.map_cfg.support_dist == slam.map_cfg.voxel_size and slam.map_cfg.support_sym
    assert slam.tp.band_samples == 8 and slam.bp_current.measure_bias
    assert np.all(np.isfinite(slam.sdf_bias)) and slam.sdf_bias[0] != 0.0
    assert slam.sdf_bias[0] == slam.sdf_bias[1]
    assert abs(float(slam.sdf_bias[0]) - float(jslam.sdf_bias[0])) < 0.05
    assert slam.dropped_delta_events == 0
    assert int(slam.state.map_state.n_active) > 0


def test_kitti_quality_json_matches_jax_config():
    sys.path.insert(0, ROOT)
    import bench

    ref = load_config(CFG_PATH, bench.BENCH_OVERRIDES + bench.QUALITY_OVERRIDES
                      + ["data_specs.n_frames=30", "tpu_specs.defer_sync=false"])
    path = os.path.join(ROOT, "nerfloam_tpu_torch", "configs", "kitti_quality.json")
    cfg = load_json_config(path)
    assert cfg.as_dict() == ref.as_dict()
    with open(path) as f:
        tpu = json.load(f)["tpu_specs"]
    assert tpu["support_dist"] == -1 and tpu["support_sym"] is True
    assert tpu["band_samples"] == 8 and tpu["bias_correction"] is True
    assert tpu["active_cap"] == 131072 and tpu["touched_cap"] == 32768
    assert tpu["defer_sync"] is False
