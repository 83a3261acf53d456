"""Port parity: a ray draw and the deferred warm start, folded into one
launch each on the card (sampling.draw_keys, tracking.ray_draw /
ray_superset / ray_pick, se3.const_vel), through their plain twins on the
CPU.

- Each twin against the chain of eager operations the port ran before
  (the Gumbel keys, the gathers, ray_prep, the band target; BA's superset,
  its per-iteration pick and its draw without one), torch.equal on seeded
  inputs: a dp rank's block of columns, BA's W > 1 and its frame mask.
- ``ray_draw_plain`` on JAX's own draw (the same numpy Gumbel noise through
  ``sample_ray_indices`` on both sides) against JAX's draw setup
  (nerfloam_tpu/core/tracking.py:150-163 and ``t_cap_for``), eager and
  jitted, bit for bit.
- A BA step (hit table and grid sampler over the superset, the grid
  without one) and a GN tracker frame (hits and grid, a dp rank's block of
  the draw handled as one process), bit-equal through the new functions
  and through the old chain patched in their place.
- ``const_vel_plain``, batched, bit for bit the per-pair chain of se3's
  matrix ops (pose matrices, inverse, products, log) that the CPU's
  ``_const_vel`` took, which tests/test_torch_defer.py holds to JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import sampling as jsampling
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.core.pipeline import _const_vel
from nerfloam_tpu_torch.models.decoder import decoder_leaves
from nerfloam_tpu_torch.ops import sampling as tsampling
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_config_from_jax,
    map_state_from_numpy,
)
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

torch.set_num_threads(2)
TRUNC = 0.3


def _frames(W, P, seed):
    """W seeded frames of P points 1e-2 to 40 m out (every 97th at the
    origin), cosines in [-0.2, 1] (a third at 1), 80% valid."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((W, P, 3)) * 10 ** rng.uniform(-2, 1.6, (W, P, 1))).astype(
        np.float32)
    pts[:, ::97] = 0.0
    cos = np.where(rng.uniform(size=(W, P)) < 0.33, 1.0, rng.uniform(-0.2, 1.0, (W, P)))
    return (torch.as_tensor(pts), torch.as_tensor(cos.astype(np.float32)),
            torch.as_tensor(rng.uniform(size=(W, P)) < 0.8))


# the chains the port ran before the draw's kernels

def _old_draw(valid, n, gen):
    noise = -torch.log(-torch.log(torch.clamp(torch.rand(valid.shape, generator=gen),
                                              min=torch.finfo(torch.float32).tiny)))
    _, idx = torch.topk(torch.where(valid, 0.0, -1e9) + noise, n, dim=-1)
    return idx, torch.gather(valid, -1, idx)


def _old_bias_ray(pcos, sdf_bias):
    b2 = (torch.zeros((2,)) if sdf_bias is None
          else torch.as_tensor(sdf_bias, dtype=torch.float32).reshape(-1)[:2])
    return torch.where(pcos < 0.999, b2[0], b2[1])


def _old_tracker_draw(points, cos, valid, n, gen, sdf_bias, rows):
    ridx, rvalid = _old_draw(valid, n, gen)
    ridx, rvalid = ridx[rows], rvalid[rows]
    pts, pcos = points[ridx], cos[ridx]
    rp = ttr.ray_prep(pts, pcos, TRUNC, MAX_DEPTH)
    return ttr.RayDraw(pts, pcos, rvalid, *rp, _old_bias_ray(pcos, sdf_bias))


def _old_superset(points, cos, valid, K, gen):
    frame = torch.arange(points.shape[0])[:, None]
    sidx, svalid = _old_draw(valid, K, gen)
    sup_pts, sup_cos = points[frame, sidx], cos[frame, sidx]
    dirs, t_cap, _, _, dnorm = ttr.ray_prep(sup_pts, sup_cos, TRUNC, MAX_DEPTH)
    return sup_pts, sup_cos, dirs, t_cap, dnorm, svalid


def _old_pick(sup, active, N, gen, cols):
    sup_pts, sup_cos, sup_dirs, _, sup_dnorm, svalid = sup
    W, K = svalid.shape
    frame = torch.arange(W)[:, None]
    ridx = torch.randint(0, K, (W, N), generator=gen)
    rvalid = torch.gather(svalid, 1, ridx)
    ridx, rvalid = ridx[:, cols], rvalid[:, cols]
    pts3, pcos2, dirs, dnorm = (x[frame, ridx] for x in (sup_pts, sup_cos, sup_dirs, sup_dnorm))
    n = ridx.numel()
    return ttr.RayPick((rvalid & active[:, None]).reshape(n), pts3.reshape(n, 3),
                       pcos2.reshape(n), dirs, dnorm.reshape(n),
                       (frame * K + ridx).reshape(n).to(torch.int32))


def _old_exact_draw(points, cos, valid, active, N, gen, cols):
    frame = torch.arange(points.shape[0])[:, None]
    ridx, rvalid = _old_draw(valid, N, gen)
    ridx, rvalid = ridx[:, cols], rvalid[:, cols]
    pts3, pcos2 = points[frame, ridx], cos[frame, ridx]
    rp = ttr.ray_prep(pts3, pcos2, TRUNC, MAX_DEPTH)
    return ttr.RayDraw(pts3, pcos2, rvalid & active[:, None], *rp, _old_bias_ray(pcos2, None))


def _same(a, b):
    assert type(a)._fields == type(b)._fields
    for nm, x, y in zip(type(a)._fields, a, b):
        assert x.shape == y.shape and torch.equal(x, y), nm


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rows", [slice(None), slice(256, 512)], ids=["whole", "dp_block"])
@pytest.mark.parametrize("bias", [None, "tensor", "array"])
def test_tracker_draw_equals_the_old_chain(rows, bias):
    """The keys and ray_draw_plain of a tracker's draw (every column, or a dp
    rank's block) equal the old chain, with a band target from a tensor, a
    numpy array or none."""
    pts, cos, val = (x[0] for x in _frames(1, 4096, 1))
    sdf_bias = {None: None, "tensor": torch.tensor([0.25, -0.5]),
                "array": np.asarray([0.1, 0.2, 0.3], np.float32)}[bias]
    u = torch.rand(val.shape, generator=_gen(2))
    noise = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    assert torch.equal(tsampling.draw_keys(u, val), torch.where(val, 0.0, -1e9) + noise)
    got = ttr.ray_draw(tsampling.draw_indices(val, 1024, _gen(3)), rows, pts, cos, val, TRUNC,
                       MAX_DEPTH, sdf_bias)
    _same(got, _old_tracker_draw(pts, cos, val, 1024, _gen(3), sdf_bias, rows))
    assert bool(got.rvalid.all()) and 0 < int(got.depth_ok.sum()) < got.depth_ok.numel()


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("cols", [slice(None), slice(512, 1024)], ids=["whole", "dp_block"])
def test_ba_draws_equal_the_old_chain(W, cols):
    """BA's superset (W frames), a pick from it with a frame mask and its draw
    without a superset, through the twins, equal the old chain (every column
    or a dp rank's block)."""
    pts, cos, val = _frames(W, 4096, 4 + W)
    active = torch.arange(W) != 1
    K = 2048
    sup = ttr.ray_superset(tsampling.draw_indices(val, K, _gen(5)), pts, cos, val, TRUNC,
                           MAX_DEPTH)
    old = _old_superset(pts, cos, val, K, _gen(5))
    sp, sc, sd, st, sn, sv = old
    assert torch.equal(sup.dirs, sd) and torch.equal(sup.t_cap, st) and torch.equal(sup.valid, sv)
    assert torch.equal(sup.rows, torch.cat([sd, sp, sc[..., None], sn[..., None]], -1))
    gen = _gen(6)
    pick = ttr.ray_pick(torch.randint(0, K, (W, 1024), generator=gen), cols, sup, active)
    _same(pick, _old_pick(old, active, 1024, _gen(6), cols))
    assert pick.dirs.is_contiguous()
    got = ttr.ray_draw(tsampling.draw_indices(val, 1024, _gen(7)), cols, pts, cos, val, TRUNC,
                       MAX_DEPTH, frame_active=active)
    _same(got, _old_exact_draw(pts, cos, val, active, 1024, _gen(7), cols))
    if W > 1:
        assert not bool(got.rvalid[1].any()) and bool(got.rvalid[0].any())


def _jax_draw_setup(points, points_cos, points_valid, noise, n, sdf_bias):
    """JAX's draw and its setup (nerfloam_tpu/core/tracking.py:150-163) on a
    given Gumbel draw."""
    orig = jax.random.gumbel
    jax.random.gumbel = lambda key, shape, dtype=jnp.float32: noise
    try:
        ridx, rvalid = jsampling.sample_ray_indices(jax.random.key(0), points_valid, n)
    finally:
        jax.random.gumbel = orig
    pts = points[ridx]
    pcos = points_cos[ridx]
    dirs = pts / (jnp.linalg.norm(pts, axis=-1, keepdims=True) + 1e-8)
    t_cap = jtr.t_cap_for(pts, pcos, TRUNC, MAX_DEPTH)
    d_meas = jnp.linalg.norm(pts, axis=-1) * pcos
    depth_ok = (d_meas > 0.0) & (d_meas < MAX_DEPTH)
    b2 = jnp.broadcast_to(jnp.asarray(sdf_bias, jnp.float32).reshape(-1)[:2], (2,))
    bias_ray = jnp.where(pcos < 0.999, b2[0], b2[1])
    return (pts, pcos, rvalid, dirs, t_cap, d_meas, depth_ok, jnp.linalg.norm(pts, axis=-1),
            bias_ray)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_ray_draw_plain_matches_jax(jit):
    """The port's draw on a given numpy Gumbel draw (sample_ray_indices'
    noise) and ray_draw_plain of its indices equal JAX's draw and setup bit
    for bit, every output."""
    pts, cos, val = (x[0].numpy() for x in _frames(1, 8192, 9))
    noise = np.random.default_rng(10).gumbel(size=val.shape).astype(np.float32)
    sdf_bias = np.asarray([0.0123, -0.0456], np.float32)
    fn = _jax_draw_setup
    if jit:
        fn = jax.jit(_jax_draw_setup, static_argnums=4)
    ref = fn(jnp.asarray(pts), jnp.asarray(cos), jnp.asarray(val), jnp.asarray(noise), 2048,
             jnp.asarray(sdf_bias))
    idx, _ = tsampling.sample_ray_indices(torch.as_tensor(val), 2048,
                                          noise=torch.as_tensor(noise))
    got = ttr.ray_draw(idx, slice(None), torch.as_tensor(pts), torch.as_tensor(cos),
                       torch.as_tensor(val), TRUNC, MAX_DEPTH, torch.as_tensor(sdf_bias))
    for nm, g, r in zip(ttr.RayDraw._fields, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=nm)
    assert int(got.depth_ok.sum()) > 0 and (got.t_cap == MAX_DEPTH).any()


@pytest.fixture(scope="module")
def trained(scene):
    """A map with random embeddings over the scene's frames, a decoder, and
    two padded frames with their poses, on the port's side."""
    _, frames = scene
    m = build_map(frames)
    emb = np.random.default_rng(5).normal(size=m.embeddings.shape).astype(np.float32) * 0.2
    m = jvm.refresh_active(m._replace(embeddings=jnp.asarray(emb)), MAP_CFG)
    params, _ = init_decoder(jax.random.key(3))
    padded = [pad_frame(pts, cos) for pts, cos, _ in frames[:2]]
    poses = [np.asarray(jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))) for *_, T in frames[:2]]
    return dict(ms=map_state_from_numpy(jax.device_get(m), device="cpu"),
                params=decoder_params_from_jax(jax.device_get(params), device="cpu"),
                P=torch.as_tensor(np.stack([np.asarray(f[0]) for f in padded])),
                C=torch.as_tensor(np.stack([np.asarray(f[1]) for f in padded])),
                V=torch.as_tensor(np.stack([np.asarray(f[2]) for f in padded])),
                poses=torch.as_tensor(np.stack(poses)))


def _patch_old_chain(monkeypatch, module):
    """Put the old chain in the place of ``module``'s draw functions: the
    draw's keys and gathers in eager operations, then ray_prep and the band
    target, returning what the new functions return."""

    def draw_indices(valid, n, generator):
        return _old_draw(valid, n, generator)[0]

    def ray_draw(idx, cols, points, points_cos, points_valid, truncation, max_depth,
                 sdf_bias=None, frame_active=None):
        sel = idx[..., cols]
        if idx.dim() == 1:
            pts, pcos, rvalid = points[sel], points_cos[sel], torch.gather(points_valid, -1, sel)
        else:
            frame = torch.arange(idx.shape[0])[:, None]
            pts, pcos = points[frame, sel], points_cos[frame, sel]
            rvalid = torch.gather(points_valid, -1, sel)
        if frame_active is not None:
            rvalid = rvalid & frame_active[:, None]
        rp = ttr.ray_prep(pts, pcos, truncation, max_depth)
        return ttr.RayDraw(pts, pcos, rvalid, *rp, _old_bias_ray(pcos, sdf_bias))

    def ray_superset(idx, points, points_cos, points_valid, truncation, max_depth):
        frame = torch.arange(idx.shape[0])[:, None]
        pts, pcos = points[frame, idx], points_cos[frame, idx]
        dirs, t_cap, _, _, dnorm = ttr.ray_prep(pts, pcos, truncation, max_depth)
        return ttr.Superset(torch.cat([dirs, pts, pcos[..., None], dnorm[..., None]], -1), dirs,
                            t_cap, torch.gather(points_valid, 1, idx))

    def ray_pick(ridx, cols, sup, frame_active):
        W, K = sup.valid.shape
        old = (sup.rows[..., 3:6], sup.rows[..., 6], sup.dirs, None, sup.rows[..., 7], sup.valid)
        sup_pts, sup_cos, sup_dirs, _, sup_dnorm, svalid = old
        frame = torch.arange(W)[:, None]
        rvalid = torch.gather(svalid, 1, ridx)
        ridx, rvalid = ridx[:, cols], rvalid[:, cols]
        pts3, pcos2, dirs, dnorm = (x[frame, ridx]
                                    for x in (sup_pts, sup_cos, sup_dirs, sup_dnorm))
        n = ridx.numel()
        return ttr.RayPick((rvalid & frame_active[:, None]).reshape(n), pts3.reshape(n, 3),
                           pcos2.reshape(n), dirs, dnorm.reshape(n),
                           (frame * K + ridx).reshape(n).to(torch.int32))

    for nm, fn in (("draw_indices", draw_indices), ("ray_draw", ray_draw),
                   ("ray_superset", ray_superset), ("ray_pick", ray_pick)):
        if hasattr(module, nm):
            monkeypatch.setattr(module, nm, fn)


def _equal_results(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            for p, q in zip(decoder_leaves(x), decoder_leaves(y)):
                assert torch.equal(p, q)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("sampler, superset", [("hits", 2), ("grid", 2), ("grid", 0)])
def test_ba_step_equals_the_old_chain(trained, monkeypatch, sampler, superset):
    """A BA step of 2 frames (one inactive pose, every frame active) through
    ray_superset / ray_pick (or ray_draw without a superset) equals the same
    step with the old chain in their place, every output bit for bit."""
    s = trained
    rc = RaycastConfig(**RC._replace(sampler=sampler, max_hits=20)._asdict())
    bp = tba.BAParams(n_frames=2, n_rays=64, num_iterations=3, truncation=0.5,
                      max_depth=MAX_DEPTH, fs_weight=1.0, sdf_weight=1e4, ray_superset=superset,
                      surface_anchor=1, band_samples=8)
    cfg = map_config_from_jax(MAP_CFG)

    def step():
        return tba.ba_step(s["ms"], cfg, rc, bp, s["params"], s["poses"], s["P"], s["C"], s["V"],
                           torch.tensor([True, True]), torch.tensor([False, True]), True,
                           [0.01, 0.005, 0.001], torch.Generator().manual_seed(4))

    new = step()
    _patch_old_chain(monkeypatch, tba)
    old = step()
    _equal_results(new, old)
    assert float(new.loss) > 0 and int(new.touched_count) > 0


@pytest.mark.parametrize("sampler", ["hits", "grid"])
def test_gn_frame_equals_the_old_chain(trained, monkeypatch, sampler):
    """A GN tracker frame (quality stack columns, a band target) through
    draw_indices and ray_draw equals the frame with the old chain in their
    place, bit for bit; so does the Adam tracker's with a draw every
    iteration."""
    s = trained
    rc = RaycastConfig(**RC._replace(sampler=sampler)._asdict())
    tp = ttr.TrackParams(n_rays=96, num_iterations=3, truncation=0.5, max_depth=MAX_DEPTH,
                         fs_weight=1.0, sdf_weight=1e4, surface_anchor=1, band_samples=8,
                         resample_rays=True)
    cfg = map_config_from_jax(MAP_CFG)
    init = s["poses"][1] + torch.tensor([0.02, -0.01, 0.0, 0.0, 0.0, 0.004])
    bias = torch.tensor([0.01, -0.005])

    def track():
        gn = ttr.track_frame_gn(s["ms"], cfg, rc, tp, s["params"], init, s["P"][1], s["C"][1],
                                s["V"][1], torch.Generator().manual_seed(6), bias)
        adam = ttr.track_frame(s["ms"], cfg, rc, tp, s["params"], init, s["P"][1], s["C"][1],
                               s["V"][1], 0.01, torch.Generator().manual_seed(7), bias)
        return (*gn, *adam)

    new = track()
    _patch_old_chain(monkeypatch, ttr)
    old = track()
    _equal_results(new, old)
    assert int(new[1]) > 0 and not torch.equal(new[0], init)


def _old_const_vel(last6, prev6, full):
    t_last, t_prev = tse3.pose_matrix(last6), tse3.pose_matrix(prev6)
    rel = tse3.compose_matrices(tse3.invert_matrix(t_prev), t_last)
    t_const = tse3.compose_matrices(t_last, rel)
    if not full:
        t_const = torch.cat([torch.cat([t_last[:3, :3], t_const[:3, 3:]], 1), t_last[3:]], 0)
    return tse3.pose_from_matrix(t_const)


@pytest.mark.parametrize("full", [True, False], ids=["full", "translation"])
@pytest.mark.parametrize("sigma", [3e-5, 1e-3, 0.8, 3.0])
def test_const_vel_plain_equals_the_matrix_chain(sigma, full):
    """const_vel_plain over 300 seeded pose pairs at once equals, bit for
    bit, the chain of se3's matrix ops one pair a call (the CPU's
    _const_vel before it; its products round as XLA's CPU dot) and the
    CPU's _const_vel of each pair, on exp_so3's series branch, the exact
    one and angles past pi."""
    rng = np.random.default_rng(int(sigma * 1e5) + full)
    prev = np.concatenate([rng.uniform(-50, 50, (300, 3)), rng.normal(0, sigma, (300, 3))], 1)
    step = np.concatenate([rng.normal(0, 1.0, (300, 3)), rng.normal(0, sigma, (300, 3))], 1)
    last = torch.as_tensor((prev + step).astype(np.float32))
    prev = torch.as_tensor(prev.astype(np.float32))
    got = tse3.const_vel(last, prev, full)
    old = torch.stack([_old_const_vel(a, b, full) for a, b in zip(last, prev)])
    one = torch.stack([_const_vel(a, b, full) for a, b in zip(last[:100], prev[:100])])
    assert torch.equal(got.view(torch.int32), old.view(torch.int32))
    assert torch.equal(one.view(torch.int32), got[:100].view(torch.int32))
