"""Port parity: the hits half of ops/raycast (build_hit_table = K4's plain
twin, sample_from_hits, resolve_cells_in_hits, pack/unpack) against the JAX
package, on one bridged map and the same rays. Integers exact, floats
1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfloam_tpu.core import tracking as jtr
from nerfloam_tpu.ops import raycast as jrc
from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.utils.bridge import hit_table_from_numpy, map_state_from_numpy, to_numpy
from tests.test_cdf_sampler import MAP_CFG as WALL_CFG, RC as WALL_RC, build_wall_map, rays_along_x
from tests.test_render_track import MAP_CFG, MAX_DEPTH, RC, build_map, pad_frame, scene  # noqa: F401

torch.set_num_threads(2)
TOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _rc_t(rc):
    return trc.RaycastConfig(**rc._replace(sampler="hits")._asdict())


@pytest.fixture(scope="module")
def scene_rays(scene):
    """Oblique rays of frame 0 of the box scene, on the scene map."""
    _, frames = scene
    m = build_map(frames)
    pts, cos, T = frames[0]
    p, c, v = pad_frame(pts, cos)
    idx = np.nonzero(np.asarray(v))[0][::7][:256]
    p, c = p[idx], c[idx]
    pose6 = jse3.pose_from_matrix(jnp.asarray(T, jnp.float32))
    dirs = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-8)
    d = jse3.rotate_dirs(pose6, dirs)
    o = jnp.broadcast_to(jse3.pose_translation(pose6), d.shape)
    return m, MAP_CFG, RC._replace(sampler="hits", max_hits=20), o, d, jtr.t_cap_for(p, c, 0.5, MAX_DEPTH)


@pytest.fixture(scope="module")
def wall_rays():
    o, d, t_cap = rays_along_x(32)
    return build_wall_map(), WALL_CFG, WALL_RC._replace(sampler="hits", max_hits=20), o, d, t_cap


def _both_tables(case):
    m, cfg, rc, o, d, t_cap = case
    jht = jrc.build_hit_table(m, cfg, rc, o, d, t_cap)
    tm = map_state_from_numpy(jax.device_get(m), device="cpu")
    tcfg = MapConfig(capacity=cfg.capacity, grid_dim=cfg.grid_dim, voxel_size=cfg.voxel_size)
    tht = trc.build_hit_table(tm, tcfg, _rc_t(rc), _t(o), _t(d), _t(t_cap))
    return jht, tht


@pytest.mark.parametrize("case", ["wall_rays", "scene_rays"])
def test_build_hit_table_matches_jax(case, request):
    jht, tht = _both_tables(request.getfixturevalue(case))
    for name in ("aid", "cell", "ray_mask"):
        np.testing.assert_array_equal(to_numpy(getattr(tht, name)), np.asarray(getattr(jht, name)))
    for name in ("t_near", "seg", "cdf"):
        np.testing.assert_allclose(to_numpy(getattr(tht, name)), np.asarray(getattr(jht, name)),
                                   atol=TOL, rtol=TOL)
    assert bool(tht.ray_mask.any())


@pytest.mark.parametrize("case", ["wall_rays", "scene_rays"])
def test_sample_and_resolve_match_jax(case, request):
    c = request.getfixturevalue(case)
    jht, _ = _both_tables(c)
    tht = hit_table_from_numpy(jax.device_get(jht), device="cpu")
    R, M = jht.aid.shape[0], 24
    u = np.random.default_rng(0).uniform(1e-4, 1 - 1e-4, size=(R, M)).astype(np.float32)
    jz, jonehot, jaid, jvalid, jmask = jrc.sample_from_hits(jht, M, None, u=jnp.asarray(u))
    tz, tj, taid, tvalid, tmask = trc.sample_from_hits(tht, M, _t(u))
    np.testing.assert_allclose(to_numpy(tz), np.asarray(jz), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(to_numpy(tj), np.asarray(jnp.argmax(jonehot, -1)))
    np.testing.assert_array_equal(to_numpy(taid), np.asarray(jaid))
    np.testing.assert_array_equal(to_numpy(tvalid), np.asarray(jvalid))
    np.testing.assert_array_equal(to_numpy(tmask), np.asarray(jmask))

    # re-resolve the samples after a 3 cm shift of the origin
    o, d = np.asarray(c[3]) + 0.03, np.asarray(c[4])
    xyz = o[:, None, :] + d[:, None, :] * np.asarray(jz)[..., None]
    cells = np.floor(xyz / c[1].voxel_size).astype(np.int32)
    jo, ja, jf = jrc.resolve_cells_in_hits(jht, jnp.asarray(cells))
    ti, ta, tf = trc.resolve_cells_in_hits(tht, _t(cells))
    np.testing.assert_array_equal(to_numpy(ta), np.asarray(ja))
    np.testing.assert_array_equal(to_numpy(tf), np.asarray(jf))
    first = np.asarray(jnp.argmax(jo > 0, -1))
    np.testing.assert_array_equal(to_numpy(ti)[np.asarray(jf)], first[np.asarray(jf)])
    assert 0 < np.asarray(jf).mean() <= 1


def test_pack_unpack_roundtrip(wall_rays):
    jht, tht = _both_tables(wall_rays)
    packed = trc.pack_hit_table(tht)
    np.testing.assert_array_equal(to_numpy(packed), np.asarray(jrc.pack_hit_table(jht)))
    back = trc.unpack_hit_table(packed)
    for a, b in zip(back, tht):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))


def test_hit_table_respects_max_hits_and_t_cap(wall_rays):
    m, cfg, rc, o, d, t_cap = wall_rays
    _, tht = _both_tables((m, cfg, rc._replace(max_hits=3), o, d, jnp.full_like(t_cap, 6.0)))
    assert tht.aid.shape[1] == 3
    assert bool(((tht.t_near + tht.seg) <= 6.0 + 1e-5).all())
