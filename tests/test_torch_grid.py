"""Port parity for the grid sampler (K9a march_occupancy, K9b
place_samples_cdf through their plain twins on the CPU), the grid
render_rays, the GN tracker's grid iteration and BA's grid gradients,
against the JAX package on the same numpy inputs and jitter. Tolerances:
- cdf, n_occ, aid, valid and ray_mask exact; z within 1e-6 (in practice
  exact: both sides round every step alike);
- render_rays: masks exact, z_vals 1e-6, sdf 1e-5 (f32 decoder, as in
  test_torch_render.py);
- one GN iteration with band columns: H, b and loss 1e-4 relative (the
  slice-1 GN test);
- BA loss 1e-5 relative, each gradient 1e-4 of its largest entry (the
  slice-1 BA test);
- a 10-frame GN slice on the grid sampler, tracker and BA, on both sides:
  ATE under 0.30 m each and within 0.10 m of each other (random streams
  differ, as in test_torch_pipeline.py);
- the replica_gate60 JSON equals the JAX package's config of the same
  overrides.
"""

import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

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
from nerfloam_tpu_torch.core import losses as tlosses
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.utils import evaluation as tev
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_config_from_jax,
    map_state_from_numpy,
    to_numpy,
)
from nerfloam_tpu_torch.utils.config import derive_static_shapes, finalize, load_json_config
from nerfloam_tpu.utils.config import derive_static_shapes as j_shapes
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
T_RC = trc.RaycastConfig(**RC._asdict())
T_CFG = map_config_from_jax(MAP_CFG)
TRUNC, FS_W, SDF_W = 0.5, 1.0, 1e4
N_BAND = 8


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(to_numpy(got).astype(np.float64) - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def setup(scene):
    """A map with random embeddings, 192 rays of frame 1 marched at the
    frame's pose, a pose 2 cm / 0.3 deg off it to place samples at, and the
    jitters both sides take."""
    _, frames = scene
    m = build_map(frames)
    rng = np.random.default_rng(6)
    emb = rng.normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    params, meta = init_decoder(jax.random.key(4))
    pts, cos, T = frames[1]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::9][:192]
    p, c = p[idx], c[idx]
    dirs = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    pose0 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    t_cap = jtr.t_cap_for(p, c, TRUNC, MAX_DEPTH)
    R = len(idx)
    return dict(
        m=m, tm=map_state_from_numpy(jax.device_get(m), device="cpu"), params=params, meta=meta,
        tparams=decoder_params_from_jax(jax.device_get(params), device="cpu"), p=p, c=c,
        dirs=dirs, pose0=pose0, t_cap=t_cap, ray_valid=jnp.asarray(rng.uniform(size=R) > 0.05),
        u=rng.uniform(1e-4, 1 - 1e-4, size=(R, RC.n_samples)).astype(np.float32),
        band_u=rng.uniform(size=(R, N_BAND)).astype(np.float32),
        pose=pose0 + jnp.asarray([0.02, -0.01, 0.0, 0.0, 0.0, 0.005], jnp.float32),
    )


def _rays(pose6, dirs, lib):
    d = lib.rotate_dirs(pose6, dirs)
    t = lib.pose_translation(pose6)
    return (t.expand_as(d) if lib is tse3 else jnp.broadcast_to(t, d.shape)), d


def _occupancy(s, j_cap=None, t_cap=None):
    """Both sides' march at pose0, each over its t_cap (default: the
    fixture's, JAX's at TRUNC, on both)."""
    j_cap = s["t_cap"] if j_cap is None else j_cap
    t_cap = _t(s["t_cap"]) if t_cap is None else t_cap
    o, d = _rays(s["pose0"], s["dirs"], jse3)
    jocc = jrc.march_occupancy(s["m"], MAP_CFG, RC, o, d, j_cap)
    to, td = _rays(_t(s["pose0"]), _t(s["dirs"]), tse3)
    tocc = trc.march_occupancy(s["tm"], T_CFG, T_RC, to, td, t_cap)
    return jocc, tocc


@pytest.mark.parametrize("trunc", [0.5, 0.3])
def test_march_and_place_match_jax(setup, trunc):
    """Each side's useful range (JAX's t_cap_for, the port's ray_prep_plain)
    at the truncation (0.3: the shipped configs'; 0.5 is a power of two,
    where a reciprocal times it is the division), bit-equal, then the march and the placement over it."""
    s = setup
    j_cap = jtr.t_cap_for(s["p"], s["c"], trunc, MAX_DEPTH)
    t_cap = ttr.ray_prep_plain(_t(s["p"]), _t(s["c"]), trunc, MAX_DEPTH).t_cap
    np.testing.assert_array_equal(to_numpy(t_cap), np.asarray(j_cap))
    jocc, tocc = _occupancy(s, j_cap, t_cap)
    np.testing.assert_array_equal(to_numpy(tocc[0]), np.asarray(jocc[0]))
    np.testing.assert_array_equal(to_numpy(tocc[1]), np.asarray(jocc[1]))
    assert 0.5 < float(np.mean(np.asarray(jocc[1]) > 0)) <= 1.0
    o, d = _rays(s["pose"], s["dirs"], jse3)
    jz, jaid, jvalid, jmask = jrc.place_samples_cdf(s["m"], MAP_CFG, RC, *jocc, o, d, j_cap,
                                                    None, u=jnp.asarray(s["u"]))
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    tz, taid, tvalid, tmask = trc.place_samples_cdf(s["tm"], T_CFG, T_RC, *tocc, to, td,
                                                    t_cap, _t(s["u"]))
    np.testing.assert_array_equal(to_numpy(taid), np.asarray(jaid))
    np.testing.assert_array_equal(to_numpy(tvalid), np.asarray(jvalid))
    np.testing.assert_array_equal(to_numpy(tmask), np.asarray(jmask))
    np.testing.assert_allclose(to_numpy(tz), np.asarray(jz), rtol=0, atol=1e-6)
    assert 0.3 < float(np.asarray(jvalid).mean()) < 1.0
    # sample_rays_cdf is the two passes in a row (raycast.py:346-381)
    jall = jrc.sample_rays_cdf(s["m"], MAP_CFG, RC, o, d, j_cap, None, u=jnp.asarray(s["u"]))
    tall = trc.sample_rays_cdf(s["tm"], T_CFG, T_RC, to, td, t_cap, _t(s["u"]))
    for t, j in zip(tall, jall):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("origin", ["per ray", "expanded"])
def test_placer_march_matches_jax(setup, origin):
    """A placer made by its own march (``CdfPlacer.march``, as the trackers
    and BA make theirs) holds JAX's march_occupancy cdf and n_occ, and
    places JAX's place_samples_cdf samples, with one origin per ray (BA's
    superset) and with one origin expanded to every ray (the trackers')."""
    s = setup
    jocc, _ = _occupancy(s)
    to, td = _rays(_t(s["pose0"]), _t(s["dirs"]), tse3)
    if origin == "per ray":
        to = to.contiguous()
    assert to.stride(0) == (3 if origin == "per ray" else 0)
    placer = trc.CdfPlacer.march(s["tm"], T_CFG, T_RC, to, td, _t(s["t_cap"]), RC.n_samples)
    np.testing.assert_array_equal(to_numpy(placer.cdf), np.asarray(jocc[0]))
    np.testing.assert_array_equal(to_numpy(placer.n_occ), np.asarray(jocc[1]))
    o, d = _rays(s["pose"], s["dirs"], jse3)
    jout = jrc.place_samples_cdf(s["m"], MAP_CFG, RC, *jocc, o, d, s["t_cap"], None,
                                 u=jnp.asarray(s["u"]))
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    tout = placer(to.contiguous() if origin == "per ray" else to, td, _t(s["u"]))
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to_numpy(tout[1]), np.asarray(jout[1]))
    np.testing.assert_array_equal(to_numpy(tout[2]), np.asarray(jout[2]))
    assert 0.3 < float(np.asarray(jout[2]).mean()) < 1.0


def test_placer_march_rejects_unconverted_inputs(setup):
    """CdfPlacer.march (and march_occupancy, one march of a fresh placer)
    converts and copies nothing: a wrong dtype, a strided tensor, a shape
    other than (C, 3) / (C,) or a map table of another dtype raises."""
    s = setup
    to, td = _rays(_t(s["pose0"]), _t(s["dirs"]), tse3)
    tc = _t(s["t_cap"])
    ok = dict(rays_o=to, rays_d=td, t_cap=tc)
    bad = [("rays_d", td.double(), "rays_d must be a contiguous"),
           ("rays_d", td.t().contiguous().t(), "rays_d must be a contiguous"),
           ("t_cap", tc.double(), "t_cap must be a contiguous"),
           ("t_cap", tc[:-1], "t_cap has shape"),
           ("rays_o", torch.cat([to, to], 1)[:, :3], "rays_o must be"),
           ("rays_o", to.double(), "rays_o must be")]
    for key, value, match in bad:
        with pytest.raises(ValueError, match=match):
            trc.CdfPlacer.march(s["tm"], T_CFG, T_RC, **{**ok, key: value},
                                n_samples=RC.n_samples)
        with pytest.raises(ValueError, match=match):
            trc.march_occupancy(s["tm"], T_CFG, T_RC, **{**ok, key: value})
    for field, value in (("region_min", s["tm"].region_min.long()),
                         ("grid_active", s["tm"].grid_active.long())):
        with pytest.raises(ValueError, match=f"{field} must be a contiguous"):
            trc.march_occupancy(s["tm"]._replace(**{field: value}), T_CFG, T_RC, **ok)


def test_place_samples_shared_origin_equals_its_copy(setup):
    """The trackers hand K9b one origin expanded to every ray (row stride
    0), through a CdfPlacer made once per frame; the wrapper reads it as it
    is and gives what the copied rows give."""
    s = setup
    _, tocc = _occupancy(s)
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    assert to.stride(0) == 0
    args = (s["tm"], T_CFG, T_RC, *tocc)
    shared = trc.place_samples_cdf(*args, to, td, _t(s["t_cap"]), _t(s["u"]))
    copied = trc.place_samples_cdf(*args, to.contiguous(), td, _t(s["t_cap"]), _t(s["u"]))
    plain = trc.place_samples_cdf_plain(*args, to, td, _t(s["t_cap"]), _t(s["u"]))
    placer = trc.CdfPlacer(*args, _t(s["t_cap"]), RC.n_samples)  # a tracker's, once per frame
    placed = placer(to, td, _t(s["u"]))
    for a, b, c, d in zip(shared, copied, plain, placed):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert bool(shared[2].any())


def test_place_samples_superset_rows_equal_the_gathered_rows(setup):
    """BA's form: a CdfPlacer over a superset cdf, each iteration's rays
    picking their rows with ``rows``, gives what place_samples_cdf gives
    on the gathered cdf, n_occ and t_cap rows, bitwise."""
    s = setup
    _, (cdf, n_occ) = _occupancy(s)
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    tc, u = _t(s["t_cap"]), _t(s["u"])
    C = cdf.shape[0]
    rows = torch.as_tensor(np.random.default_rng(3).integers(0, C, C // 2), dtype=torch.int32)
    R = rows.shape[0]
    placer = trc.CdfPlacer(s["tm"], T_CFG, T_RC, cdf, n_occ, tc, RC.n_samples, R)
    idx = rows.long()
    o, d = to[idx].contiguous(), td[idx].contiguous()
    for it in range(2):  # a BA step's iterations: one placer, new rows each time
        r_it = rows.flip(0) if it else rows
        i_it = r_it.long()
        got = placer(o, d, u[:R], r_it)
        want = trc.place_samples_cdf(s["tm"], T_CFG, T_RC, cdf[i_it], n_occ[i_it], o, d, tc[i_it],
                                     u[:R])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool(got[2].any())
    with pytest.raises(ValueError, match="need rows"):
        placer(o, d, u[:R])
    with pytest.raises(ValueError, match="rows must be a contiguous"):
        placer(o, d, u[:R], rows.long())
    with pytest.raises(ValueError, match="rows has shape"):
        placer(o, d, u[:R], rows[:-1])


def test_place_samples_rejects_unconverted_inputs(setup):
    """The wrapper converts and copies nothing: a wrong dtype, a strided
    tensor or rows of another stride raise instead."""
    s = setup
    _, (cdf, n_occ) = _occupancy(s)
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    tc, u = _t(s["t_cap"]), _t(s["u"])
    ok = dict(cdf=cdf, n_occ=n_occ, rays_o=to, rays_d=td, t_cap=tc, u=u)
    bad = [("cdf", cdf.double(), "cdf must be a contiguous"),
           ("n_occ", cdf[:, -1], "n_occ must be a contiguous"),
           ("rays_d", td.t().contiguous().t(), "rays_d must be a contiguous"),
           ("u", u.half(), "u must be a contiguous"),
           ("t_cap", tc[:, None], "t_cap has shape"),
           ("rays_o", torch.cat([to, to], 1)[:, :3], "rays_o must be"),
           ("rays_o", to.double(), "rays_o must be")]
    for key, value, match in bad:
        with pytest.raises(ValueError, match=match):
            trc.place_samples_cdf(s["tm"], T_CFG, T_RC, **{**ok, key: value})
    state = s["tm"]._replace(region_min=s["tm"].region_min.long())
    with pytest.raises(ValueError, match="region_min must be a contiguous"):
        trc.place_samples_cdf(state, T_CFG, T_RC, **ok)


def test_render_rays_grid_matches_jax(setup):
    s = setup
    jocc, tocc = _occupancy(s)
    o, d = _rays(s["pose"], s["dirs"], jse3)
    jout = jrender.render_rays(s["m"], MAP_CFG, RC, s["params"], s["meta"], o, d, s["t_cap"],
                               s["ray_valid"], None, occupancy=jocc, jitter_u=jnp.asarray(s["u"]))
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    placer = trc.CdfPlacer(s["tm"], T_CFG, T_RC, *tocc, _t(s["t_cap"]), RC.n_samples)
    tout = trender.render_rays(s["tm"].packed, s["tparams"], trender.ActiveField(s["tm"], T_CFG),
                               to, td, _t(s["ray_valid"]), placer, _t(s["u"]))
    np.testing.assert_array_equal(to_numpy(tout.valid_mask), np.asarray(jout.valid_mask))
    np.testing.assert_array_equal(to_numpy(tout.ray_mask), np.asarray(jout.ray_mask))
    np.testing.assert_allclose(to_numpy(tout.z_vals), np.asarray(jout.z_vals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_numpy(tout.sdf), np.asarray(jout.sdf), atol=1e-5)
    np.testing.assert_allclose(to_numpy(tout.sampled_xyz), np.asarray(jout.sampled_xyz),
                               atol=1e-6)


def test_gn_grid_iteration_matches_jax(setup):
    """tracking.py:246-315 on the grid sampler (263-267) with band and
    anchor columns, rebuilt from its exposed pieces."""
    s = setup
    m, vs, M = s["m"], MAP_CFG.voxel_size, RC.n_samples
    tp = ttr.TrackParams(n_rays=192, num_iterations=1, truncation=TRUNC, max_depth=MAX_DEPTH,
                         fs_weight=1.0, sdf_weight=1000.0, surface_anchor=1, band_samples=N_BAND)
    jocc, tocc = _occupancy(s)
    rvalid, pcos, p = s["ray_valid"], s["c"], s["p"]
    origin, wdirs = _rays(s["pose"], s["dirs"], jse3)
    t_pos = s["pose"][:3]
    z, flid, vmask, _ = jrc.place_samples_cdf(m, MAP_CFG, RC, *jocc, origin, wdirs, s["t_cap"],
                                              None, u=jnp.asarray(s["u"]))
    vmask = vmask & rvalid[:, None]
    embs = m.packed[jnp.clip(flid, 0)]
    dnorm = jnp.linalg.norm(p, axis=-1)
    ez = jnp.concatenate([dnorm[:, None],
                          jrender.band_sample_z(None, dnorm, pcos, TRUNC, N_BAND,
                                                u=jnp.asarray(s["band_u"]))], 1)
    exyz = origin[:, None, :] + wdirs[:, None, :] * ez[..., None]
    eaid = jvm.lookup_active(m, MAP_CFG, jnp.floor(exyz / vs).astype(jnp.int32))
    z = jnp.concatenate([z, ez], 1)
    vmask = jnp.concatenate([vmask, (eaid >= 0) & rvalid[:, None] & (ez > 0)], 1)
    embs = jnp.concatenate([embs, m.packed[jnp.clip(eaid, 0)]], 1)
    xyz = origin[:, None, :] + wdirs[:, None, :] * z[..., None]

    def field(x):
        return jrender.field_from_embs(MAP_CFG, s["params"], s["meta"], x, embs)

    sdf = field(xyz)
    g = jax.grad(lambda x: jnp.sum(field(x)))(xyz)
    d_meas = dnorm * pcos
    depth_ok = (d_meas > 0) & (d_meas < MAX_DEPTH)
    zc = z * pcos[:, None]
    dd = d_meas[:, None]
    front = (zc < dd - TRUNC) & vmask
    band = vmask & ~front & ~(zc > dd + TRUNC) & depth_ok[:, None]
    nf, ns = jnp.sum(front), jnp.sum(band)
    tot = jnp.maximum(nf + ns, 1).astype(jnp.float32)
    r = jnp.where(front, sdf - 1.0, (zc + sdf * TRUNC) - dd)
    w = jnp.where(front, tp.fs_weight * (1 - nf / tot), tp.sdf_weight * (1 - ns / tot))
    w = w * (front | band)
    gj = g * jnp.where(front, 1.0, TRUNC)[..., None]
    J = jnp.concatenate([gj, jnp.cross(xyz - t_pos, gj)], -1)
    hp = jax.lax.Precision.HIGHEST
    H = jnp.einsum("nmi,nmj->ij", J * w[..., None], J, precision=hp)
    b = jnp.einsum("nmi,nm->i", J * w[..., None], r, precision=hp)
    assert float(jnp.sum(band[:, :M])) > 100

    # port: K9b + K8 columns -> decoder fwd/bwd -> one K2 -> K3 (plain twins)
    to, td = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    tpts, tc, trv = _t(p), _t(pcos), _t(rvalid)
    tdn = torch.linalg.norm(tpts, dim=-1)
    tez = trender.extra_surface_z(tdn, tc, TRUNC, 1, N_BAND, _t(s["band_u"]))
    placer = trc.CdfPlacer(s["tm"], T_CFG, T_RC, *tocc, _t(s["t_cap"]), RC.n_samples)
    field = trender.ActiveField(s["tm"], T_CFG)
    (tz, tvalid, taid, txyz, tfeats), ray_hit = trender.grid_columns_fwd(
        field, placer, _t(s["u"]), to, td, s["tm"].packed, (field, tez, trv))
    tsdf, tg = ttr.field_and_grad(s["tparams"], tfeats, txyz, taid, tvalid, s["tm"].packed, vs,
                                  torch.float32)
    tvm_ = tvalid & trv[:, None]
    tdm = tdn * tc
    tH, tb, tloss = ttr.gn_system(txyz, _t(s["pose"])[:3], tz, tsdf, tg, tvm_, tc, tdm,
                                  (tdm > 0) & (tdm < MAX_DEPTH), tp)
    np.testing.assert_array_equal(to_numpy(tvm_), np.asarray(vmask))
    np.testing.assert_allclose(to_numpy(tz), np.asarray(z), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to_numpy(ray_hit), np.asarray(jocc[1]) > 0)
    assert _rel_err(tH, H) <= 1e-4
    assert _rel_err(tb, b) <= 1e-4
    np.testing.assert_allclose(float(tloss), float(jnp.sum(w * r * r)), rtol=1e-4)


def test_ba_grid_gradients_match_jax(setup):
    """One BA loss on the grid sampler (ba.py:241-247, 275-280) with band
    columns: loss and gradients w.r.t. the packed table, the decoder and
    the pose against jax.grad."""
    s = setup
    jocc, tocc = _occupancy(s)

    def j_loss(packed, params, pose6):
        o, d = _rays(pose6, s["dirs"], jse3)
        st = s["m"]._replace(packed=packed)
        out = jrender.render_rays(st, MAP_CFG, RC, params, s["meta"], o, d, s["t_cap"],
                                  s["ray_valid"], None, occupancy=jocc,
                                  jitter_u=jnp.asarray(s["u"]))
        ez, esdf, eval_ = jrender.extra_surface_columns(
            st, MAP_CFG, params, s["meta"], o, d, jnp.linalg.norm(s["p"], axis=-1), s["c"],
            s["ray_valid"], TRUNC, 0, N_BAND, None, band_u=jnp.asarray(s["band_u"]))
        cat = lambda a, b: jnp.concatenate([a, b], axis=1)  # noqa: E731
        loss, _ = jlosses.sdf_losses(cat(out.z_vals, ez), cat(out.sdf, esdf),
                                     cat(out.valid_mask, eval_), out.ray_mask, s["p"], s["c"],
                                     TRUNC, MAX_DEPTH, FS_W, SDF_W)
        return loss

    jl, jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(s["m"].packed, s["params"], s["pose"])
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
    placer = trc.CdfPlacer(s["tm"], T_CFG, T_RC, *tocc, _t(s["t_cap"]), RC.n_samples)
    field = trender.ActiveField(s["tm"], T_CFG)
    out = trender.render_rays(packed, params, field, o, d, rv, placer, _t(s["u"]),
                              extra=(field, ez, rv))
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


SLICE = CANON + [
    "data_specs.n_frames=10",
    "tpu_specs.bootstrap_steps=6",
    "tpu_specs.sampler=grid",
    "tpu_specs.track_method=gn",
    "tpu_specs.recenter_margin=8.0",
    "tpu_specs.defer_sync=false",
]


@pytest.fixture(scope="module")
def grid_runs():
    cfg = load_config(CFG_PATH, SLICE)
    ds = get_dataset(cfg)
    gt = ds.gt_trajectory()
    jax_poses = np.asarray(NerfLoamSLAM(cfg, ds).run())
    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    port_poses = np.asarray(slam.run())
    return gt, jax_poses, port_poses, slam


def test_grid_slice_matches_jax(grid_runs):
    gt, jax_poses, port_poses, slam = grid_runs
    assert slam.rc_track.sampler == slam.rc_map.sampler == "grid"
    assert port_poses.shape == jax_poses.shape == (10, 4, 4)
    ate_jax = ev.ate_rmse(jax_poses, gt[:10], align=False)
    ate_port = ev.ate_rmse(port_poses, gt[:10], align=False)
    assert ate_jax < 0.30, ate_jax
    assert ate_port < 0.30, ate_port
    assert abs(ate_port - ate_jax) <= 0.10, (ate_port, ate_jax)
    assert slam.dropped_delta_events == 0
    # the port's numpy evaluation equals the JAX package's
    for align in (False, True):
        assert tev.ate_rmse(port_poses, gt[:10], align=align) == pytest.approx(
            ev.ate_rmse(port_poses, gt[:10], align=align), rel=1e-12)


def test_replica_gate60_json_matches_jax_config():
    spec = importlib.util.spec_from_file_location(
        "calibrate_gate60", os.path.join(ROOT, "scripts", "calibrate_gate60.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = load_config(os.path.join(ROOT, "configs", "synthetic", "kitti_replica_ci.yaml"),
                      mod.GATE60 + mod.LEAN + ["tpu_specs.defer_sync=false"])
    path = os.path.join(ROOT, "nerfloam_tpu_torch", "configs", "replica_gate60.json")
    cfg = load_json_config(path)
    assert cfg.as_dict() == ref.as_dict()
    assert derive_static_shapes(cfg) == j_shapes(ref)
    with open(path) as f:
        d = json.load(f)
    assert d["tpu_specs"]["sampler"] == "grid" and d["tpu_specs"]["track_method"] == "gn"
    assert d["tpu_specs"]["touched_cap"] == 0 and d["tpu_specs"]["defer_sync"] is False
    assert d["data_specs"]["n_frames"] == 60 and d["data_specs"]["world"] == "kitti_replica"
    slam = NerfLoamSLAM_torch(cfg, None, device="cpu")  # every knob is ported
    assert slam.bp_current.touched_cap == 8192 and slam.bp_random.touched_cap == 32768
