"""Port parity for the reference-exact fallbacks (exact embedding
gradients through E1, BA without a ray superset, the Adam tracker's
per-iteration rays) on the CPU, against the JAX package on the same numpy
inputs. Where JAX draws internally (a ray draw's Gumbel noise, the
placement jitter), both sides are handed the same numpy draws in the
same order: ``jax.random.gumbel`` / ``jax.random.uniform`` and the port's
``sampling.gumbel`` / ``uniform_jitter`` are replaced for the test (JAX's
one-iteration BA step takes them as constants of its trace; its tracker
runs with jit disabled so that its loop draws anew every iteration).
Tolerances:
- E1's forward equals JAX's pack_embeddings exactly (a gather); its plain
  transpose equals jax.vjp(pack_embeddings) bit for bit in f32 (XLA's
  scatter adds its updates in order: ascending (row, slot), from 0, one
  rounding each), with corners shared by several voxels, padding rows and
  a -1 corner; the reverse order gives another table, so the test tells
  the orders apart;
- K2's d packed is exactly +0.0 at the padding rows (which E1's
  transpose leaves out);
- one exact-path BA loss 1e-5 relative and its gradients w.r.t. the
  canonical table, the decoder and the pose 1e-4 of each one's largest
  entry (test_torch_grid.py's BA bounds: sdf_weight 1e4 amplifies
  rounding);
- one superset-0 BA step (a fresh draw and march, one Adam step, K5's
  mean reconcile): loss 1e-5 relative, touched count and update counts
  exact, poses within 1e-5 of their lr, tables and decoder within 1e-2
  of theirs (Adam's first step is g / (|g| + eps): where |g| is near
  eps = 1e-8, a gradient rounding difference d moves the entry by up to
  d / (4 eps) of lr; measured 2.6e-3 on the tables, 1.2e-4 on the
  decoder), the surface bias 1e-4 relative;
- the Adam tracker with ``resample_rays``, 2 iterations on fresh draws,
  each marched at the current pose: the second's loss 1e-5 relative and
  hits exact, the pose within 2e-2 of the learning rate (each Adam step
  moves a component by about lr; a pose gradient within 1e-4 of its
  largest entry can still move a small component's normalized step by
  a few parts in a thousand);
- the GN tracker ignores ``resample_rays``: the same digits with it on;
- exact gradients with bfloat16 embeddings: the JAX BA loop fails as it
  is traced, and the port raises at construction;
- a 6-frame slice with all four fallbacks and kitti_exact.json:
  tests/test_torch_exact_runs.py (its own file, so that the test runner's
  workers can take the two files side by side).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfloam_tpu.core import ba as jba
from nerfloam_tpu.core import losses as jlosses
from nerfloam_tpu.core import render as jrender
from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import losses as tlosses
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.map import voxel_map as tvm
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.ops import sampling as tsampling
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_config_from_jax,
    map_state_from_numpy,
    to_numpy,
)
from nerfloam_tpu_torch.utils.config import finalize
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


def _rays(pose6, dirs, lib):
    d = lib.rotate_dirs(pose6, dirs)
    t = lib.pose_translation(pose6)
    return (t.expand_as(d) if lib is tse3 else jnp.broadcast_to(t, d.shape)), d


@pytest.fixture(scope="module")
def setup(scene):
    """A map with random embeddings, the same map with a -1 corner put into
    one active voxel (``m1``: E1 reads row 0 for it), 192 rays of frame 1,
    a pose 2 cm / 0.3 deg off the frame's, and the jitters both sides
    take."""
    _, frames = scene
    m = build_map(frames)
    rng = np.random.default_rng(6)
    emb = rng.normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    cidx = np.array(m.corner_idx)
    cidx[int(m.active_ids[5]), 3] = -1
    m1 = jvm.refresh_active(m._replace(corner_idx=jnp.asarray(cidx)), MAP_CFG)
    params, meta = init_decoder(jax.random.key(4))
    pts, cos, T = frames[1]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::9][:192]
    p, c = p[idx], c[idx]
    R = len(idx)
    return dict(
        m=m, tm=map_state_from_numpy(jax.device_get(m), device="cpu"), m1=m1,
        tm1=map_state_from_numpy(jax.device_get(m1), device="cpu"), params=params, meta=meta,
        frames=frames, p=p, c=c, dirs=p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8),
        t_cap=jtr.t_cap_for(p, c, TRUNC, MAX_DEPTH),
        ray_valid=jnp.asarray(rng.uniform(size=R) > 0.05),
        u=rng.uniform(1e-4, 1 - 1e-4, size=(R, RC.n_samples)).astype(np.float32),
        band_u=rng.uniform(size=(R, N_BAND)).astype(np.float32),
        pose=jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
        + jnp.asarray([0.02, -0.01, 0.0, 0.0, 0.0, 0.005], jnp.float32),
    )


def _tparams(s):
    return decoder_params_from_jax(jax.device_get(s["params"]), device="cpu")


def test_pack_embeddings_fwd_matches_jax(setup):
    s = setup
    n = int(s["m1"].n_active)
    assert n < MAP_CFG.capacity  # padding rows, active_ids 0
    got = tvm.pack_embeddings_fwd(s["tm1"], T_CFG, s["tm1"].embeddings)
    np.testing.assert_array_equal(to_numpy(got),
                                  np.asarray(jvm.pack_embeddings(s["m1"], MAP_CFG)))


def test_pack_embeddings_vjp_plain_equals_jax_vjp(setup):
    """Bit for bit in f32: every corner's entries added in ascending (row,
    slot) from 0. Entries of mixed magnitudes, so that another order
    rounds differently."""
    s = setup
    m, tm = s["m1"], s["tm1"]
    A, n, F = MAP_CFG.capacity, int(m.n_active), MAP_CFG.feat_dim
    rng = np.random.default_rng(9)
    d = (rng.normal(size=(A, 8 * F)) * 10.0 ** rng.uniform(-4, 4, size=(A, 8 * F)))
    d[n:] = 0.0  # no sample reaches a padding row
    d = d.astype(np.float32)
    _, vjp = jax.vjp(lambda e: jvm.pack_embeddings(m._replace(embeddings=e), MAP_CFG),
                     m.embeddings)
    (ref,) = vjp(jnp.asarray(d))
    got = tvm.pack_embeddings_vjp_plain(_t(d), tm.active_ids, tm.corner_idx, tm.n_active,
                                        MAP_CFG.capacity)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref))
    # the data: corners shared by several voxels, and row 0 standing in for a -1 corner
    cidx = np.asarray(m.corner_idx)[np.asarray(m.active_ids)[:n]]
    mult = np.bincount(np.clip(cidx, 0, None).ravel(), minlength=A)
    assert mult.max() >= 4 and (cidx == -1).sum() == 1
    # the scratch's CPU path is the same function
    scratch = tvm.PackGradScratch().build(tm, T_CFG)
    assert torch.equal(tvm.pack_embeddings_vjp(_t(d), scratch), got)
    # the reverse order rounds differently: the comparison above tells orders apart
    idx = torch.clamp(tm.corner_idx[tm.active_ids[:n].long()], min=0).reshape(-1)
    rev = tvm._add_in_order(torch.zeros((A, F)), idx.flip(0),
                            _t(d)[:n].reshape(-1, F).flip(0))
    assert not torch.equal(rev, got)


def _exact_loss_jax(s, emb, params, pose6):
    """ba.py:222-227, 245-250, 262-312 for one frame: the canonical table
    repacked, the rays marched at pose6 (occupancy None), band columns;
    on the map with a -1 corner."""
    st = s["m1"]._replace(embeddings=emb)
    st = st._replace(packed=jvm.pack_embeddings(st, MAP_CFG))
    o, d = _rays(pose6, s["dirs"], jse3)
    out = jrender.render_rays(st, MAP_CFG, RC, params, s["meta"], o, d, s["t_cap"],
                              s["ray_valid"], None, jitter_u=jnp.asarray(s["u"]))
    ez, esdf, eval_ = jrender.extra_surface_columns(
        st, MAP_CFG, params, s["meta"], o, d, jnp.linalg.norm(s["p"], axis=-1), s["c"],
        s["ray_valid"], TRUNC, 0, N_BAND, None, band_u=jnp.asarray(s["band_u"]))
    cat = lambda a, b: jnp.concatenate([a, b], axis=1)  # noqa: E731
    loss, _ = jlosses.sdf_losses(cat(out.z_vals, ez), cat(out.sdf, esdf),
                                 cat(out.valid_mask, eval_), out.ray_mask, s["p"], s["c"],
                                 TRUNC, MAX_DEPTH, FS_W, SDF_W)
    return loss


def _exact_loss_port(s, emb, params, pose, scratch):
    tm = s["tm1"]
    packed = tvm.PackEmbeddings.apply(emb, tm, T_CFG, scratch)
    o, d = _rays(pose, _t(s["dirs"]), tse3)
    tp, tc, rv = _t(s["p"]), _t(s["c"]), _t(s["ray_valid"])
    ez = trender.extra_surface_z(torch.linalg.norm(tp, dim=-1), tc, TRUNC, 0, N_BAND,
                                 _t(s["band_u"]))
    placer = trc.CdfPlacer.march(tm, T_CFG, T_RC, o.detach(), d.detach(), _t(s["t_cap"]),
                                 RC.n_samples)
    field = trender.ActiveField(tm, T_CFG)
    out = trender.render_rays(packed, params, field, o, d, rv, placer, _t(s["u"]),
                              extra=(field, ez, rv))
    loss, _ = tlosses.sdf_losses(out.z_vals, out.sdf, out.valid_mask, out.ray_mask, tp, tc,
                                 TRUNC, MAX_DEPTH, FS_W, SDF_W, gt_norm=ieee.norm3(tp))
    return loss, packed


def test_exact_ba_gradients_match_jax(setup):
    """The exact path's loss and its gradients w.r.t. the canonical (C, F)
    table (through E1's transpose), the decoder and the pose."""
    s = setup
    jl, jg = jax.value_and_grad(lambda *a: _exact_loss_jax(s, *a), argnums=(0, 1, 2))(
        s["m1"].embeddings, s["params"], s["pose"])
    emb = _t(s["m1"].embeddings).requires_grad_(True)
    params = _tparams(s)
    flat = params["w"] + params["b"]
    for q in flat:
        q.requires_grad_(True)
    pose = _t(s["pose"]).requires_grad_(True)
    tl, _ = _exact_loss_port(s, emb, params, pose,
                             tvm.PackGradScratch().build(s["tm1"], T_CFG))
    grads = torch.autograd.grad(tl, [emb, *flat, pose])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    je, jd, jpose = jax.device_get(jg)
    jflat = [lay["w"] for lay in jd["layers"]] + [jd["out"]["w"]]
    jflat += [lay["b"] for lay in jd["layers"]] + [jd["out"]["b"]]
    pairs = [("embeddings", grads[0], je)] + [
        (f"decoder[{i}]", g, r) for i, (g, r) in enumerate(zip(grads[1:-1], jflat))
    ] + [("pose", grads[-1], jpose)]
    for name, g, ref in pairs:
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        assert np.abs(to_numpy(g) - ref).max() <= 1e-4 * scale, name
    np.testing.assert_array_equal(to_numpy((grads[0] != 0).any(-1)), (np.asarray(je) != 0).any(-1))


def test_k2_dpacked_is_zero_at_padding_rows(setup):
    """No sample reaches an active row at or past n_active (grid_active
    never points there), so K2's d packed is +0.0 there: E1's transpose
    may leave those rows out."""
    s = setup
    packed = s["tm"].packed.clone().requires_grad_(True)
    o, d = _rays(_t(s["pose"]), _t(s["dirs"]), tse3)
    rv = _t(s["ray_valid"])
    placer = trc.CdfPlacer.march(s["tm"], T_CFG, T_RC, o, d, _t(s["t_cap"]), RC.n_samples)
    field = trender.ActiveField(s["tm"], T_CFG)
    out = trender.render_rays(packed, _tparams(s), field, o, d, rv, placer, _t(s["u"]))
    (dp,) = torch.autograd.grad(out.sdf.sum(), packed)
    n = int(s["m"].n_active)
    assert bool((dp[:n] != 0).any())
    pad = dp[n:]
    assert bool((pad == 0).all()) and not bool(torch.signbit(pad).any())


def _same_draws(monkeypatch, seed):
    """Hand both frameworks the same numpy draws, in call order: Gumbel
    noise for each ray draw, uniforms for each jitter. Returns the calls
    counted by side and kind."""
    rng = np.random.default_rng(seed)
    seqs = {"g": [], "u": []}
    counts = {"jax_g": 0, "jax_u": 0, "port_g": 0, "port_u": 0}

    def take(kind, side, shape, lo, hi):
        seq = seqs[kind]
        i = counts[f"{side}_{kind}"]
        counts[f"{side}_{kind}"] += 1
        if i == len(seq):
            seq.append((rng.gumbel(size=shape) if kind == "g"
                        else rng.uniform(lo, hi, size=shape)).astype(np.float32))
        # one frame: JAX draws it under vmap as (P,), the port as (1, P)
        assert seq[i].size == int(np.prod(shape)), (kind, seq[i].shape, shape)
        return seq[i].reshape(tuple(shape))

    def j_gumbel(key, shape, dtype=jnp.float32):
        return jnp.asarray(take("g", "jax", shape, 0, 0))

    def j_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(take("u", "jax", shape, float(minval), float(maxval)))

    def t_gumbel(shape, generator, device):
        return torch.as_tensor(take("g", "port", shape, 0, 0))

    def t_uniform(shape, generator, device):
        return torch.as_tensor(take("u", "port", shape, 1e-4, 1 - 1e-4))

    monkeypatch.setattr(jax.random, "gumbel", j_gumbel)
    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(tsampling, "gumbel", t_gumbel)
    monkeypatch.setattr(tba, "uniform_jitter", t_uniform)
    monkeypatch.setattr(ttr, "uniform_jitter", t_uniform)
    return counts


def _frame_inputs(s, i=2):
    pts, cos, T = s["frames"][i]
    p, c, v = pad_frame(pts, cos)
    return p, c, v, jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))


def test_superset0_ba_step_matches_jax(setup, monkeypatch):
    """One BA step with ``ray_superset=0`` (ba.py:245-250, 324-329): a
    fresh Gumbel draw over all the frame's points, the march at the
    current pose, one Adam step, K5's mean reconcile."""
    s = setup
    p, c, v, pose0 = _frame_inputs(s)
    pose = pose0 + jnp.asarray([0.01, 0.0, -0.01, 0.0, 0.002, 0.0], jnp.float32)
    kw = dict(n_frames=1, n_rays=256, num_iterations=1, truncation=TRUNC, max_depth=MAX_DEPTH,
              fs_weight=FS_W, sdf_weight=SDF_W, touched_cap=4096, ray_superset=0,
              surface_anchor=1)
    lrs = [0.02, 0.005, 0.001]
    counts = _same_draws(monkeypatch, 10)
    # one iteration: the loop body is traced once, so jit takes the draws as constants
    jres = jba.ba_step(s["m"], MAP_CFG, RC, jba.BAParams(**kw), s["params"], s["meta"],
                       pose[None], p[None], c[None], v[None], jnp.ones((1,), bool),
                       jnp.ones((1,), bool), jnp.asarray(True), jnp.asarray(lrs),
                       jax.random.key(0))
    tres = tba.ba_step(s["tm"], T_CFG, T_RC, tba.BAParams(**kw), _tparams(s), _t(pose)[None],
                       _t(p)[None], _t(c)[None], _t(v)[None], torch.ones((1,), dtype=torch.bool),
                       torch.ones((1,), dtype=torch.bool), True, lrs, torch.Generator())
    assert counts == {"jax_g": 1, "jax_u": 1, "port_g": 1, "port_u": 1}
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-5)
    assert int(tres.touched_count) == int(jres.touched_count) > 0
    np.testing.assert_array_equal(to_numpy(tres.upd_count), np.asarray(jres.upd_count))
    assert np.abs(to_numpy(tres.poses) - np.asarray(jres.poses)).max() <= 1e-5 * lrs[2]
    for name, got, ref in (("embeddings", tres.embeddings, jres.embeddings),
                           ("packed", tres.packed, jres.packed)):
        assert np.abs(to_numpy(got) - np.asarray(ref)).max() <= 1e-2 * lrs[0], name
    np.testing.assert_allclose(float(tres.surface_bias), float(jres.surface_bias), rtol=1e-4)
    jd = jax.device_get(jres.decoder_params)
    jflat = [lay["w"] for lay in jd["layers"]] + [jd["out"]["w"]]
    jflat += [lay["b"] for lay in jd["layers"]] + [jd["out"]["b"]]
    for g, r in zip(tres.decoder_params["w"] + tres.decoder_params["b"], jflat):
        assert np.abs(to_numpy(g) - np.asarray(r)).max() <= 1e-2 * lrs[1]


def test_adam_resample_iterations_match_jax(setup, monkeypatch):
    """The Adam tracker with ``resample_rays`` (tracking.py:418-475): each
    of 2 iterations draws fresh rays and marches them at the current pose
    (the second's loss and hits are those of its own draw and march)."""
    s = setup
    p, c, v, pose0 = _frame_inputs(s)
    init6 = pose0 + jnp.asarray([0.03, -0.02, 0.01, 0.002, -0.001, 0.004], jnp.float32)
    tp = ttr.TrackParams(n_rays=192, num_iterations=2, truncation=TRUNC, max_depth=MAX_DEPTH,
                         fs_weight=FS_W, sdf_weight=SDF_W, surface_anchor=1,
                         resample_rays=True)
    jtp = jtr.TrackParams(**{k: v_ for k, v_ in tp._asdict().items() if k != "s2s"})
    sdf_bias = np.asarray([0.021, -0.013], np.float32)
    counts = _same_draws(monkeypatch, 11)
    with jax.disable_jit():
        jres = jtr.track_frame(s["m"], MAP_CFG, RC, jtp, s["params"], s["meta"], init6, p, c, v,
                               jnp.asarray(0.05, jnp.float32), jax.random.key(0),
                               jnp.asarray(sdf_bias))
    tres = ttr.track_frame(s["tm"], T_CFG, T_RC, tp, _tparams(s), _t(init6), _t(p), _t(c), _t(v),
                           0.05, torch.Generator(), _t(sdf_bias))
    assert counts == {"jax_g": 2, "jax_u": 2, "port_g": 2, "port_u": 2}
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-5)
    assert int(tres.hit_count) == int(jres.hit_count) > 100
    assert np.abs(to_numpy(tres.pose) - np.asarray(jres.pose)).max() <= 2e-2 * 0.05
    assert np.abs(np.asarray(jres.pose) - np.asarray(init6)).max() > 0.05


def test_gn_ignores_resample_rays(setup):
    """JAX's GN tracker never reads ``resample_rays``; the port's prints the
    same digits with it on as off."""
    s = setup
    p, c, v, pose0 = _frame_inputs(s)
    init6 = _t(pose0 + jnp.asarray([0.03, -0.02, 0.01, 0.002, -0.001, 0.004], jnp.float32))
    tp = ttr.TrackParams(n_rays=192, num_iterations=3, truncation=TRUNC, max_depth=MAX_DEPTH,
                         fs_weight=FS_W, sdf_weight=1000.0, surface_anchor=1,
                         band_samples=N_BAND)
    out = []
    for rc in (T_RC, T_RC._replace(sampler="hits")):
        for resample in (False, True):
            res = ttr.track_frame_gn(s["tm"], T_CFG, rc, tp._replace(resample_rays=resample),
                                     _tparams(s), init6, _t(p), _t(c), _t(v),
                                     torch.Generator().manual_seed(3))
            out.append(res)
        assert all(torch.equal(a, b) for a, b in zip(out[-2], out[-1]))
    assert not torch.equal(out[0].pose, init6)


def test_exact_with_bf16_embeddings_fails_in_jax_and_raises_in_port(setup):
    """ba.py:357: JAX's f32 learning rate promotes a bf16 table, and the
    BA loop's carry comes back float32: the trace fails. The port raises
    at construction, naming that failure."""
    s = setup
    p, c, v, pose0 = _frame_inputs(s)
    cfg = MAP_CFG._replace(emb_dtype="bfloat16")
    m = s["m"]._replace(embeddings=s["m"].embeddings.astype(jnp.bfloat16))
    bp = jba.BAParams(n_frames=1, n_rays=64, num_iterations=1, truncation=TRUNC,
                      max_depth=MAX_DEPTH, fs_weight=FS_W, sdf_weight=SDF_W,
                      exact_embedding_grads=True)
    with pytest.raises(TypeError, match="bfloat16"):
        jax.eval_shape(lambda: jba.ba_step(
            m, cfg, RC, bp, s["params"], s["meta"], pose0[None], p[None], c[None], v[None],
            jnp.ones((1,), bool), jnp.ones((1,), bool), jnp.asarray(True),
            jnp.asarray([0.02, 0.005, 0.001]), jax.random.key(0)))
    over = ["tpu_specs.emb_dtype=bfloat16", "tpu_specs.exact_embedding_grads=true",
            "tpu_specs.defer_sync=false"]
    jcfg = load_config(CFG_PATH, CANON + over)
    with pytest.raises(ValueError, match="float32.*nerfloam_tpu/core/ba.py:357"):
        NerfLoamSLAM_torch(finalize(jcfg.as_dict()), None, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tba.ba_step(s["tm"]._replace(embeddings=s["tm"].embeddings.bfloat16()), T_CFG, T_RC,
                    tba.BAParams(n_frames=1, n_rays=64, num_iterations=1, truncation=TRUNC,
                                 max_depth=MAX_DEPTH, fs_weight=FS_W, sdf_weight=SDF_W,
                                 exact_embedding_grads=True),
                    _tparams(s), _t(pose0)[None], _t(p)[None], _t(c)[None], _t(v)[None],
                    torch.ones((1,), dtype=torch.bool), torch.ones((1,), dtype=torch.bool), True,
                    [0.02, 0.005, 0.001])
