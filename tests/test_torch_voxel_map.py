"""Port parity: map/voxel_map of nerfloam_tpu_torch against the JAX package.

Insert elections let any duplicate win (voxel_map.py:344-354), so row ids
differ between the two sides: maps are compared keyed by lattice
coordinates. Surface sets and corner sets must be equal; rows (packed
corner features, embeddings) agree to 1e-6. Operations that do not
allocate (reconcile, pack, bump) start from one bridged state, so their
row ids are shared and compared directly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfloam_tpu.map import voxel_map as jvm
from nerfloam_tpu_torch.map import voxel_map as tvm
from nerfloam_tpu_torch.utils.bridge import map_state_from_numpy, to_numpy

torch.set_num_threads(2)
VS = 0.5
CFG = dict(capacity=1 << 13, grid_dim=(48, 48, 24), voxel_size=VS, active_cap=2048)
JCFG = jvm.MapConfig(**CFG)
TCFG = tvm.MapConfig(**CFG)


def _points(seed, n=1500, shift=0.0):
    """A ground patch plus a wall, with duplicates per voxel."""
    rng = np.random.default_rng(seed)
    g = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(0.0, 0.3, n)], -1)
    w = np.stack([rng.uniform(2.0, 2.4, n // 2), rng.uniform(-3, 3, n // 2),
                  rng.uniform(0, 3, n // 2)], -1)
    pts = np.concatenate([g, w]) + np.array([shift, 0.0, 0.0])
    pts[:20] += 100.0  # out of region: dropped
    valid = rng.uniform(size=len(pts)) > 0.05
    return pts.astype(np.float32), valid


def _j_state(seed=0, **kw):
    m = jvm.recenter(jvm.create(JCFG), JCFG, jnp.zeros(3))
    pts, val = _points(seed)
    return jvm.insert_points(m, JCFG, jnp.asarray(pts), jnp.asarray(val), **kw)


def _t_state(seed=0, **kw):
    m = tvm.recenter(tvm.create(TCFG, "cpu"), TCFG, torch.zeros(3))
    pts, val = _points(seed)
    return tvm.insert_points(m, TCFG, torch.as_tensor(pts), torch.as_tensor(val), **kw)


def _np(state):
    return jax.device_get(state) if not hasattr(state.grid, "numpy") else to_numpy(state)


def _surface(s):
    s = _np(s)
    n = int(s.num_lat)
    coords = np.asarray(s.lat_coords)[:n]
    surf = np.nonzero(np.asarray(s.is_surface)[:n])[0]
    corners = {}
    for v in surf:
        corners[tuple(coords[v])] = frozenset(tuple(coords[c]) for c in np.asarray(s.corner_idx)[v])
    return set(map(tuple, coords)), corners


def _active(s):
    """active voxel coords -> packed row, plus a grid_active consistency check."""
    s = _np(s)
    n = min(int(s.n_active), len(s.active_ids))
    coords = np.asarray(s.active_coords)[:n]
    rows = {tuple(c): np.asarray(s.packed)[i] for i, c in enumerate(coords)}
    g = np.asarray(s.grid_active)
    rel = coords - np.asarray(s.region_min)
    dims = CFG["grid_dim"]
    flat = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
    assert (g[flat] == np.arange(n)).all()
    assert (g >= 0).sum() == n
    return rows


@pytest.mark.parametrize("cand_cap", [0, 512])
def test_insert_matches_jax_by_coords(cand_cap):
    j, t = _j_state(cand_cap=cand_cap), _t_state(cand_cap=cand_cap)
    assert int(j.num_lat) == int(t.num_lat)
    assert int(j.num_cand) == int(t.num_cand)
    assert _surface(j) == _surface(t)
    # the grid maps every allocated row's cell back to that row
    tn = to_numpy(t)
    n = int(tn.num_lat)
    ids = to_numpy(tvm.lookup(t, TCFG, t.lat_coords[:n]))
    np.testing.assert_array_equal(ids, np.arange(n))


def test_second_insert_and_append_active_match_jax():
    j = jvm.refresh_active(_j_state(), JCFG)
    t = tvm.refresh_active(_t_state(), TCFG)
    pts, val = _points(1, shift=1.3)
    j = jvm.insert_points(j, JCFG, jnp.asarray(pts), jnp.asarray(val), append_active=True)
    t = tvm.insert_points(t, TCFG, torch.as_tensor(pts), torch.as_tensor(val), append_active=True)
    assert _surface(j) == _surface(t)
    assert int(j.n_active) == int(t.n_active)
    jr, tr = _active(j), _active(t)
    assert jr.keys() == tr.keys()


def test_refresh_and_recenter_match_jax():
    rng = np.random.default_rng(3)
    j, t = _j_state(), _t_state()
    # same embeddings keyed by coords so packed rows can be compared
    emb = {c: rng.normal(size=16).astype(np.float32) for c in _surface(j)[0]}

    def with_emb(s, lib):
        sn = _np(s)
        e = np.zeros((CFG["capacity"], 16), np.float32)
        for i, c in enumerate(np.asarray(sn.lat_coords)[: int(sn.num_lat)]):
            e[i] = emb[tuple(c)]
        return s._replace(embeddings=jnp.asarray(e) if lib == "j" else torch.as_tensor(e))

    j, t = with_emb(j, "j"), with_emb(t, "t")
    for center in ([0.0, 0.0, 0.0], [3.3, -2.1, 0.4]):
        j = jvm.recenter_refresh(j, JCFG, jnp.asarray(center, jnp.float32))
        t = tvm.recenter_refresh(t, TCFG, torch.tensor(center))
        np.testing.assert_array_equal(to_numpy(t.region_min), np.asarray(j.region_min))
        assert int(j.n_active) == int(t.n_active)
        jr, tr = _active(j), _active(t)
        assert jr.keys() == tr.keys()
        for c in jr:
            np.testing.assert_allclose(tr[c], jr[c], atol=1e-6)


def test_maybe_recenter_refresh_matches_jax():
    j = jvm.refresh_active(_j_state(), JCFG)
    t = tvm.refresh_active(_t_state(), TCFG)
    for c, margin in (([1.0, 0.0, 0.0], 2.0), ([5.0, 0.0, 0.0], 2.0)):
        j2 = jvm.maybe_recenter_refresh(j, JCFG, jnp.asarray(c, jnp.float32), margin)
        t2 = tvm.maybe_recenter_refresh(t, TCFG, torch.tensor(c), margin)
        np.testing.assert_array_equal(to_numpy(t2.region_min), np.asarray(j2.region_min))
        assert _active(j2).keys() == _active(t2).keys()


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_reconcile_pack_bump_match_jax(emb_dtype):
    cfg_j = JCFG._replace(emb_dtype=emb_dtype)
    cfg_t = TCFG._replace(emb_dtype=emb_dtype)
    j = jvm.refresh_active(_j_state(), cfg_j)
    rng = np.random.default_rng(4)
    emb = rng.normal(size=j.embeddings.shape).astype(np.float32)
    j = jvm.refresh_active(j._replace(embeddings=jnp.asarray(emb).astype(j.embeddings.dtype)), cfg_j)
    t = map_state_from_numpy(jax.device_get(j), device="cpu")
    A = int(j.packed.shape[0])
    n = int(j.n_active)
    new_packed = np.asarray(j.packed) + rng.normal(size=j.packed.shape).astype(np.float32) * 0.01
    touched = np.zeros(A, bool)
    touched[rng.choice(n, n // 3, replace=False)] = True
    for cap in (A, max(n // 6, 1)):  # second cap truncates the touched set
        je = jvm.reconcile_packed(j, cfg_j, jnp.asarray(new_packed), jnp.asarray(touched), cap)
        te = tvm.reconcile_packed(t, cfg_t, torch.as_tensor(new_packed),
                                  torch.as_tensor(touched), cap)
        # bf16: both add the same f32 deltas after casting them to bf16; a
        # corner shared by k touched voxels takes k bf16 adds whose order
        # differs, so the bound is one bf16 ulp of the embedding scale
        tol = 1e-6 if emb_dtype == "float32" else 2e-2
        np.testing.assert_allclose(to_numpy(te), np.asarray(je, np.float32), atol=tol)
    jp = jvm.pack_embeddings(j._replace(embeddings=je), cfg_j)
    tp = tvm.pack_embeddings(t._replace(embeddings=te), cfg_t)
    np.testing.assert_allclose(to_numpy(tp), np.asarray(jp), atol=tol)
    np.testing.assert_array_equal(
        to_numpy(tvm.bump_upd_count(t, cfg_t, torch.as_tensor(touched))),
        np.asarray(jvm.bump_upd_count(j, cfg_j, jnp.asarray(touched))))


def test_grow_keeps_rows():
    t = tvm.refresh_active(_t_state(), TCFG)
    big, cfg = tvm.grow(t, TCFG, TCFG.capacity * 2)
    assert cfg.capacity == 2 * TCFG.capacity
    assert big.lat_coords.shape[0] == cfg.capacity
    assert _surface(big) == _surface(t)
    assert int(big.num_lat) <= cfg.capacity
