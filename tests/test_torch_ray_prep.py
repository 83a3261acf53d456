"""Port parity: the lengths of the port's ray setup and of the
scan-to-scan range image, bit for bit against the JAX package on the CPU.

- ``tracking.ray_prep_plain`` (csrc/ray_prep.cu's twin; what ``ray_prep``
  takes on the CPU) against JAX's ray directions, ``t_cap_for``, measured
  depth, its gate and the points' lengths (nerfloam_tpu/core/tracking.py:
  156-160, 374-381) at truncation 0.3 and 0.5, eager and under jit; and
  against ``ieee.norm3`` of the points and the division by it.
- The depths hoisted out of the loops: a BA step (hit table and grid
  sampler over the ray superset, the grid without one) and the Adam
  tracker (fixed rays and a draw every iteration), band and anchor
  columns on, take every iteration's measured lengths from the draw's
  ``ray_prep`` (gathered with the rays from the superset): each is
  ``ieee.norm3`` of the iteration's points, and the step's every output
  equals the loop form's, where ``sdf_losses`` takes the norm itself.
- The scan-to-scan twin (core/scan2scan.py, K11a's and K11b's plain
  versions) takes ``jnp.linalg.norm``'s lengths at JAX's four sites
  (nerfloam_tpu/core/scan2scan.py:72 the range, :74 the horizontal range,
  :122 a pixel's depth, :135 its normal's length): each length the twin
  takes, on its own inputs, equals ``jnp.linalg.norm`` of them."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu.models.decoder import init_decoder
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import scan2scan as ts2s
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.models.decoder import decoder_leaves
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_config_from_jax,
    map_state_from_numpy,
)
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from test_scan2scan import SP as JSP, corridor_scan  # noqa: E402

torch.set_num_threads(2)
SP = ts2s.Scan2ScanParams(**JSP._asdict())


def _vectors(n, seed):
    """n seeded (n, 3) f32 rows, magnitudes 1e-3 to 1e3, every 97th zero."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 3)) * 10 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)
    x[::97] = 0.0
    return x


# the twin's lengths in the order build_prev_scan_plain takes them: (the
# helper, its call, JAX's site)
S2S_SITES = {"range": ("norm3_plain", 0, ":72"), "horizontal range": ("norm2_plain", 0, ":74"),
             "normal length": ("norm3_plain", 1, ":135"), "depth": ("norm3_plain", 2, ":122")}


@pytest.mark.parametrize("site", list(S2S_SITES))
def test_s2s_twin_norms_match_jax(site, monkeypatch):
    """build_prev_scan_plain on a corridor scan with random-magnitude points
    among its own: every length it takes at ``site`` equals
    ``jnp.linalg.norm`` of the same inputs (over the (x, y) part for the
    horizontal range) bit for bit, where the three-products-and-two-adds
    form it had before differs."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([corridor_scan(rng), _vectors(4096, 1) * 0.05 + 5.0,
                          np.zeros((256, 3), np.float32)])
    valid = np.concatenate([np.ones(len(pts) - 256, bool), np.zeros(256, bool)])
    helper, call, _ = S2S_SITES[site]
    seen = []
    fn = getattr(ts2s, helper)
    monkeypatch.setattr(ts2s, helper, lambda x: seen.append((x, fn(x))) or seen[-1][1])
    ts2s.build_prev_scan_plain(SP, torch.as_tensor(pts), torch.as_tensor(valid),
                               torch.zeros(6))
    x, got = seen[call]
    x = x.numpy()
    ref = np.asarray(jnp.linalg.norm(jnp.asarray(x[..., :2] if helper == "norm2_plain" else x),
                                     axis=-1))
    assert got.shape == ref.shape and got.numel() >= 4096
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    cols = 2 if helper == "norm2_plain" else 3
    adds = np.sqrt(sum((x[..., i] * x[..., i]).astype(np.float32) for i in range(cols))
                   .astype(np.float32))
    print(f"[s2s] {site}: {got.numel()} lengths equal to jnp.linalg.norm; the products-and-adds "
          f"form differs on {int((adds != ref).sum())}")
    if site != "normal length":  # unit-scale normals' lengths round alike more often
        assert (adds != ref).sum() > 50


def test_norm2_plain_matches_jax():
    """ieee.norm2_plain is jnp.linalg.norm of the (x, y) part on 65,536
    seeded rows, bit for bit: sqrt(fma(y, y, x * x))."""
    x = _vectors(65536, 2)
    ref = np.asarray(jnp.linalg.norm(jnp.asarray(x[:, :2]), axis=-1))
    np.testing.assert_array_equal(ieee.norm2_plain(torch.as_tensor(x)).numpy(), ref)


def _jax_ray_prep(p, c, trunc):
    """JAX's per-ray setup (tracking.py:156-160, t_cap_for)."""
    n = jnp.linalg.norm(p, axis=-1)
    d_meas = jnp.linalg.norm(p, axis=-1) * c
    return (p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8),
            jtr.t_cap_for(p, c, trunc, MAX_DEPTH), d_meas, (d_meas > 0.0) & (d_meas < MAX_DEPTH), n)


@pytest.mark.parametrize("trunc", [0.3, 0.5])
def test_ray_prep_plain_matches_jax(trunc):
    """Every output of ray_prep (the plain twin on the CPU) equals JAX's,
    eager and jitted, and the same formulas on ``ieee.norm3``, on 16,384
    seeded rays (magnitudes 1e-3 to 1e3, zero rows, cosines below 0.05 and
    negative, depths past max_depth)."""
    x = _vectors(16384, 3)
    c = np.random.default_rng(3).uniform(-0.2, 1.0, 16384).astype(np.float32)
    tx, tc = torch.as_tensor(x), torch.as_tensor(c)
    got = ttr.ray_prep(tx, tc, trunc, MAX_DEPTH)
    assert isinstance(got, ttr.RayPrep)
    jit_prep = jax.jit(_jax_ray_prep, static_argnums=2)
    for ref in (_jax_ray_prep(jnp.asarray(x), jnp.asarray(c), trunc),
                jit_prep(jnp.asarray(x), jnp.asarray(c), trunc)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    n = ieee.norm3(tx)
    band = ieee.rdiv(trunc, torch.clamp(tc, min=0.05))
    before = (tx / (n[:, None] + 1e-8), torch.clamp(n + band + 0.5, max=MAX_DEPTH), n * tc)
    for g, b in zip(got, before):
        assert torch.equal(g, b)
    assert 0 < int(got.depth_ok.sum()) < 16384 and (got.t_cap == MAX_DEPTH).any()
    w = ttr.ray_prep(tx.reshape(4, 4096, 3), tc.reshape(4, 4096), trunc, MAX_DEPTH)
    for g, b in zip(got, w):
        assert torch.equal(g, b.reshape(g.shape))


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


def _loop_form(monkeypatch, module):
    """Patch ``module``'s extra_surface_z to record the depths it is handed
    and its sdf_losses to take the points' norm itself (the loop form),
    recording the length it was handed and ieee.norm3 of its points; returns
    the records, one [ez depths, loss length, loss norm] an iteration."""
    seen = []
    ez_fn, loss_fn = module.extra_surface_z, module.sdf_losses

    def extra_surface_z(dnorm, *a, **k):
        seen.append([dnorm])
        return ez_fn(dnorm, *a, **k)

    def sdf_losses(z, sdf, valid, ray_mask, gt_points, *a, gt_norm=None, **k):
        seen[-1] += [gt_norm, ieee.norm3(gt_points)]
        return loss_fn(z, sdf, valid, ray_mask, gt_points, *a, gt_norm=ieee.norm3(gt_points),
                       **k)

    monkeypatch.setattr(module, "extra_surface_z", extra_surface_z)
    monkeypatch.setattr(module, "sdf_losses", sdf_losses)
    return seen


def _check_records(seen, n):
    assert len(seen) == n
    for ez_depth, loss_norm, ref in seen:
        assert torch.equal(ez_depth, ref) and torch.equal(loss_norm, ref)


@pytest.mark.parametrize("sampler, superset", [("hits", 2), ("grid", 2), ("grid", 0)])
def test_ba_step_hoisted_depths_equal_the_loop_form(trained, monkeypatch, sampler, superset):
    s = trained
    rc = RaycastConfig(**RC._replace(sampler=sampler, max_hits=20)._asdict())
    bp = tba.BAParams(n_frames=2, n_rays=64, num_iterations=3, truncation=0.5,
                      max_depth=MAX_DEPTH, fs_weight=1.0, sdf_weight=1e4, ray_superset=superset,
                      surface_anchor=1, band_samples=8)
    cfg = map_config_from_jax(MAP_CFG)

    def step():
        return tba.ba_step(s["ms"], cfg, rc, bp, s["params"], s["poses"], s["P"], s["C"], s["V"],
                           torch.ones(2, dtype=torch.bool), torch.tensor([False, True]), True,
                           [0.01, 0.005, 0.001], torch.Generator().manual_seed(4))

    hoisted = step()
    seen = _loop_form(monkeypatch, tba)
    loop = step()
    _check_records(seen, bp.num_iterations)
    for name in tba.BAResult._fields:
        a, b = getattr(hoisted, name), getattr(loop, name)
        for x, y in (zip(decoder_leaves(a), decoder_leaves(b)) if name == "decoder_params"
                     else [(a, b)]):
            assert torch.equal(x, y), name
    assert float(hoisted.loss) > 0 and int(hoisted.touched_count) > 0


@pytest.mark.parametrize("resample", [False, True])
def test_adam_tracker_hoisted_depths_equal_the_loop_form(trained, monkeypatch, resample):
    s = trained
    rc = RaycastConfig(**RC._asdict())
    tp = ttr.TrackParams(n_rays=96, num_iterations=3, truncation=0.5, max_depth=MAX_DEPTH,
                         fs_weight=1.0, sdf_weight=1e4, surface_anchor=1, band_samples=8,
                         resample_rays=resample)
    cfg = map_config_from_jax(MAP_CFG)
    init = s["poses"][1] + torch.tensor([0.02, -0.01, 0.0, 0.0, 0.0, 0.004])

    def track():
        return ttr.track_frame(s["ms"], cfg, rc, tp, s["params"], init, s["P"][1], s["C"][1],
                               s["V"][1], 0.01, torch.Generator().manual_seed(6),
                               torch.tensor([0.01, -0.005]))

    hoisted = track()
    seen = _loop_form(monkeypatch, ttr)
    loop = track()
    _check_records(seen, tp.num_iterations)
    for a, b in zip(hoisted, loop):
        assert torch.equal(a, b)
    assert int(hoisted.hit_count) > 0 and not torch.equal(hoisted.pose, init)
