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
    return tvm.insert_points(m, TCFG, torch.as_tensor(pts), torch.as_tensor(val), **kw)[0]


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
    t, _ = tvm.insert_points(t, TCFG, torch.as_tensor(pts), torch.as_tensor(val),
                             append_active=True)
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


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_reconcile_with_kept_scratch_matches_jax(emb_dtype):
    """K5's wrapper as a BA step calls it, one ReconcileScratch kept over
    calls with different touched sets and caps, equal to JAX's
    reconcile_packed + bump_upd_count + pack_embeddings (embeddings to the
    tolerances of test_reconcile_pack_bump_match_jax, counts exact). On the
    CPU it takes the plain twin, which needs no scratch: the scratch stays
    unallocated."""
    cfg_j, cfg_t = JCFG._replace(emb_dtype=emb_dtype), TCFG._replace(emb_dtype=emb_dtype)
    j = jvm.refresh_active(_j_state(), cfg_j)
    rng = np.random.default_rng(5)
    emb = rng.normal(size=j.embeddings.shape).astype(np.float32)
    j = jvm.refresh_active(j._replace(embeddings=jnp.asarray(emb).astype(j.embeddings.dtype)), cfg_j)
    t = map_state_from_numpy(jax.device_get(j), device="cpu")
    A, n = int(j.packed.shape[0]), int(j.n_active)
    new_packed = np.asarray(j.packed) + rng.normal(size=j.packed.shape).astype(np.float32) * 0.01
    tol = 1e-6 if emb_dtype == "float32" else 2e-2
    scratch = tvm.ReconcileScratch()
    for frac, cap in ((0.3, A), (0.6, max(n // 5, 1)), (0.0, A)):  # the second truncates
        touched = np.zeros(A, bool)
        touched[rng.choice(n, int(frac * n), replace=False)] = True
        jt = jnp.asarray(touched)
        je = jvm.reconcile_packed(j, cfg_j, jnp.asarray(new_packed), jt, cap)
        got = tvm.reconcile(t, cfg_t, torch.as_tensor(new_packed), torch.as_tensor(touched), cap,
                            scratch=scratch)
        np.testing.assert_allclose(to_numpy(got.embeddings), np.asarray(je, np.float32), atol=tol)
        np.testing.assert_allclose(to_numpy(got.packed),
                                   np.asarray(jvm.pack_embeddings(j._replace(embeddings=je), cfg_j)),
                                   atol=tol)
        np.testing.assert_array_equal(to_numpy(got.upd_count),
                                      np.asarray(jvm.bump_upd_count(j, cfg_j, jt)))
        assert int(got.touched_count) == int(touched.sum())
    assert scratch.ptrs is None and scratch.head is None


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_reconcile_adds_in_jax_order(emb_dtype):
    """Exactly JAX's table: a corner shared by k touched voxels takes k adds
    in index order, each rounded to the embedding type, as XLA applies
    ``at[].add`` (the twin of K5 splits the duplicates into rounds of
    distinct indices; a bf16 ``index_add_`` on the CPU would sum them in
    float32 and round once). The deltas are small against the embeddings,
    so a single rounding and k roundings differ in bf16."""
    cfg_j, cfg_t = JCFG._replace(emb_dtype=emb_dtype), TCFG._replace(emb_dtype=emb_dtype)
    j = jvm.refresh_active(_j_state(), cfg_j)
    rng = np.random.default_rng(11)
    emb = (1.0 + rng.uniform(size=j.embeddings.shape)).astype(np.float32)
    j = jvm.refresh_active(j._replace(embeddings=jnp.asarray(emb).astype(j.embeddings.dtype)),
                           cfg_j)
    t = map_state_from_numpy(jax.device_get(j), device="cpu")
    A, n = int(j.packed.shape[0]), int(j.n_active)
    new_packed = np.asarray(j.packed) + rng.uniform(1e-3, 3e-3, size=j.packed.shape).astype(
        np.float32)
    touched = np.arange(A) < n
    je = jvm.reconcile_packed(j, cfg_j, jnp.asarray(new_packed), jnp.asarray(touched), A)
    te = tvm.reconcile_packed(t, cfg_t, torch.as_tensor(new_packed), torch.as_tensor(touched), A)
    np.testing.assert_array_equal(to_numpy(te), np.asarray(je, np.float32))
    assert not np.array_equal(np.asarray(je, np.float32), np.asarray(j.embeddings, np.float32))
    if emb_dtype == "bfloat16":  # the single-rounding sum would differ here
        once = torch.as_tensor(np.asarray(j.embeddings, np.float32))
        cflat, delta = _corner_deltas(t, cfg_t, torch.as_tensor(new_packed), A)
        once = once.index_add_(0, cflat, delta.to(torch.bfloat16).float()).to(torch.bfloat16)
        assert not torch.equal(once.float(), torch.as_tensor(to_numpy(te)))


def _corner_deltas(t, cfg, new_packed, A):
    """(corner rows, mean deltas) of every active voxel, as reconcile_packed
    forms them."""
    F = cfg.feat_dim
    cflat = t.corner_idx[t.active_ids[:int(t.n_active)].long()].reshape(-1).long()
    delta = (new_packed - t.packed)[:int(t.n_active)].reshape(-1, F)
    mult = torch.zeros(cfg.capacity).index_add_(0, cflat, torch.ones(len(cflat)))
    return cflat, delta / mult[cflat][:, None]


def test_grow_keeps_rows():
    t = tvm.refresh_active(_t_state(), TCFG)
    big, cfg = tvm.grow(t, TCFG, TCFG.capacity * 2)
    assert cfg.capacity == 2 * TCFG.capacity
    assert big.lat_coords.shape[0] == cfg.capacity
    assert _surface(big) == _surface(t)
    assert int(big.num_lat) <= cfg.capacity


# (cfg, first insert's kwargs, second insert's kwargs): the second insert
# of each case writes new rows, activates voxels and, with append_active,
# appends them; "cand_overflow" compacts past its cap (num_cand > cap) and
# "capacity_overflow" runs out of rows (num_lat > capacity: the rows past
# it are dropped)
UNDO_CASES = {
    "insert": ({}, {}),
    "append_active": ({}, {"append_active": True}),
    "cand_overflow": ({}, {"append_active": True, "cand_cap": 64}),
    "capacity_overflow": ({"capacity": 800}, {"append_active": True}),
}


@pytest.mark.parametrize("case", sorted(UNDO_CASES))
def test_insert_then_undo_restores_every_table(case):
    """insert_points works in place and returns a record; undo_insert on
    that record puts every MapState table and scalar back exactly (a clone
    of the pre-insert state), and a second undo changes nothing. The
    record's counts are what the insert wrote."""
    over, kw = UNDO_CASES[case]
    cfg = TCFG._replace(**over)
    m = tvm.recenter(tvm.create(cfg, "cpu"), cfg, torch.zeros(3))
    pts, val = _points(0)
    m, _ = tvm.insert_points(m, cfg, torch.as_tensor(pts), torch.as_tensor(val))
    rng = np.random.default_rng(12)
    m = tvm.refresh_active(m._replace(embeddings=torch.as_tensor(
        rng.normal(size=m.embeddings.shape).astype(np.float32))), cfg)
    before = tvm.MapState(*[t.clone() for t in m])
    pts, val = _points(1, shift=1.3)
    out, rec = tvm.insert_points(m, cfg, torch.as_tensor(pts), torch.as_tensor(val), **kw)
    assert out is m  # in place
    parts = tvm.record_parts(rec)
    num_lat0, n_active0, num_cand0, n_rows, n_act, n_app = parts["header"].tolist()
    assert (num_lat0, n_active0, num_cand0) == (int(before.num_lat), int(before.n_active),
                                               int(before.num_cand))
    assert n_rows == min(int(m.num_lat), cfg.capacity) - num_lat0 > 0
    assert n_act > 0 and n_app == (min(n_act, tvm.acap(cfg) - n_active0)
                                   if kw.get("append_active") else 0)
    if case == "cand_overflow":
        assert int(m.num_cand) > 64 and n_act <= 64
    if case == "capacity_overflow":
        assert int(m.num_lat) > cfg.capacity
    changed = [nm for nm in tvm.MapState._fields
               if not torch.equal(getattr(m, nm), getattr(before, nm))]
    assert {"lat_coords", "grid", "is_surface", "corner_idx", "num_lat"} <= set(changed)
    if kw.get("append_active"):
        assert {"active_ids", "grid_active", "packed", "n_active"} <= set(changed)
    for _ in range(2):
        tvm.undo_insert(m, rec)
        for nm in tvm.MapState._fields:
            assert torch.equal(getattr(m, nm), getattr(before, nm)), (case, nm)
