"""The port's mesh path against the JAX package on the CPU: marching
tetrahedra (K10b's plain twin), the mesh lattice (K10a's twin), `_mesh_chunk`
and `extract_mesh` on a JAX run's map bridged into the port, and the host
pieces (`clean_mesh`, `downsample_points`, `sample_mesh_surface`,
`mesh_metrics`, `crop_to_observed`, the PLY writer).

Tolerances: marching tetrahedra on the same cells are compared exactly (the
twin does JAX's operations in JAX's order). Behind the decoder (a matrix
product, whose summation order differs between XLA and torch) SDF values
differ by ~1e-6, so triangles are compared where both masks agree (at least
99.9% of slots) to 1e-4 m, and welded meshes as vertex sets to 1e-5 m with
equal counts."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core.pipeline import NerfLoamSLAM
from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.map import mesher as jmesher
from nerfloam_tpu.ops import marching as jmarch
from nerfloam_tpu.utils import evaluation as jev
from nerfloam_tpu.utils import logger as jlogger
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.map import mesher as tmesher
from nerfloam_tpu_torch.ops import keys as tkeys
from nerfloam_tpu_torch.ops import marching as tmarch
from nerfloam_tpu_torch.utils import evaluation as tev
from nerfloam_tpu_torch.utils import logger as tlogger
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_config_from_jax,
    map_state_from_numpy,
)

from _canon import CANON
from test_marching import _grid_cells

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")


def _both(cells, vals):
    jt, jv = jmarch.marching_tets_cells(jnp.asarray(cells), jnp.asarray(vals))
    tt, tv = tmarch.marching_tets_cells(torch.as_tensor(cells), torch.as_tensor(vals))
    return np.asarray(jt), np.asarray(jv), tt.numpy(), tv.numpy()


def _cells(kind):
    if kind == "random":
        rng = np.random.default_rng(0)
        cells = (rng.uniform(-1, 1, (500, 1, 3)) + rng.uniform(0, 0.3, (500, 8, 3))).astype(
            np.float32)
        vals = rng.normal(0, 0.2, (500, 8)).astype(np.float32)
        vals[::7, 3] = 0.0                 # exact zeros: the sign test's edge
        vals[::11] = np.abs(vals[::11])    # all-outside cells
        vals[5, :] = vals[5, 0]            # a flat cell: the 1e-12 denominator
        return cells, vals
    if kind == "sphere":
        cells = _grid_cells(17, 1.6)
        return cells, (np.linalg.norm(cells, axis=-1) - 1.0).astype(np.float32)
    cells = _grid_cells(5, 1.0)
    return cells, (cells[..., 2] - 0.13).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "sphere", "plane"])
def test_marching_tets_cells_equal_jax(kind):
    cells, vals = _cells(kind)
    jt, jv, tt, tv = _both(cells, vals)
    assert tt.shape == jt.shape == (len(cells), 12, 3, 3) and tv.shape == jv.shape
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert jv.any()
    if kind == "plane":
        np.testing.assert_allclose(tt[tv][..., 2], 0.13, atol=1e-5)


def test_marching_tables_equal_jax_and_the_cuda_source():
    for name in ("TET_CORNERS", "EDGE_PAIRS", "TRI_TABLE"):
        np.testing.assert_array_equal(getattr(tmarch, name), getattr(jmarch, name))
    import re

    with open(os.path.join(ROOT, "nerfloam_tpu_torch", "csrc", "mesh.cu")) as f:
        src = f.read()
    for cname, table in (("c_tet_corners", tmarch.TET_CORNERS), ("c_edge_pairs", tmarch.EDGE_PAIRS),
                         ("c_tri_table", tmarch.TRI_TABLE)):
        body = re.search(cname + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S).group(1)
        got = np.array([int(x) for x in re.findall(r"-?\d+", body)]).reshape(table.shape)
        np.testing.assert_array_equal(got, table)


def test_lattice_tables_and_weld_key_equal_jax():
    from nerfloam_tpu.ops.keys import COORD_MASK, weld_key_np

    for res in (2, 3, 4):
        np.testing.assert_array_equal(tmesher._lattice_fractions(res),
                                      jmesher._lattice_fractions(res))
        np.testing.assert_array_equal(tmesher._cell_corner_table(res),
                                      jmesher._cell_corner_table(res))
    c = np.random.default_rng(0).integers(0, 1 << 21, (1000, 3))
    np.testing.assert_array_equal(tkeys.weld_key_np(c), weld_key_np(c))
    assert tkeys.COORD_MASK == COORD_MASK


@pytest.fixture(scope="module")
def jax_run():
    """A 4-frame JAX run and its final state bridged into the port."""
    cfg = load_config(CFG_PATH, CANON + ["data_specs.n_frames=4", "tpu_specs.bootstrap_steps=6",
                                         "tpu_specs.defer_sync=false"])
    slam = NerfLoamSLAM(cfg, get_dataset(cfg))
    slam.run()
    st = slam.state
    tm = map_state_from_numpy(jax.device_get(st.map_state), device="cpu")
    tparams = decoder_params_from_jax(jax.device_get(st.decoder_params), device="cpu")
    return slam, tm, map_config_from_jax(slam.map_cfg), tparams


@pytest.mark.parametrize("res", [2, 3])
def test_mesh_chunk_matches_jax(jax_run, res):
    slam, tm, tcfg, tparams = jax_run
    st = slam.state
    ids = jmesher.vm.surface_snapshot(st.map_state)["voxel_ids"][:300]
    padded = np.full(384, -1, np.int32)
    padded[: len(ids)] = ids
    jt, jv = jmesher._mesh_chunk(st.map_state, slam.map_cfg, st.decoder_params, st.decoder_meta,
                                 jnp.asarray(padded), res, slam.compute_dtype)
    jt, jv = np.asarray(jt), np.asarray(jv)
    # K10a's twin against the JAX gather + einsum + positions
    feats, pos = tmesher.mesh_lattice(tm, tcfg, torch.as_tensor(padded), res)
    safe = np.clip(padded, 0, None)
    embs = np.asarray(st.map_state.embeddings, np.float32)[
        np.clip(np.asarray(st.map_state.corner_idx)[safe], 0, None)]
    w = np.asarray(jmesher.trilinear_weights(jnp.asarray(jmesher._lattice_fractions(res))))
    np.testing.assert_allclose(feats.numpy(), np.einsum("sc,bcf->bsf", w, embs), atol=1e-6)
    if res == 2:  # weights 0 / 1: the corner rows themselves
        np.testing.assert_array_equal(feats.numpy(), embs)
    base = np.asarray(st.map_state.lat_coords)[safe].astype(np.float32) * np.float32(
        tcfg.voxel_size)
    np.testing.assert_allclose(
        pos.numpy(),
        base[:, None] + jmesher._lattice_fractions(res)[None] * np.float32(tcfg.voxel_size),
        atol=1e-6)
    # the whole chunk
    tt, tv = tmesher._mesh_chunk(tm, tcfg, tparams, torch.as_tensor(padded), res,
                                 slam.compute_dtype)
    tt, tv = tt.numpy(), tv.numpy()
    assert tt.shape == jt.shape and tv.shape == jv.shape
    assert not tv[len(ids) * (res - 1) ** 3:].any()       # the padding voxels emit nothing
    agree = tv == jv
    assert agree.mean() >= 0.999, agree.mean()
    both = tv & jv
    assert both.sum() > 100
    np.testing.assert_allclose(tt[both], jt[both], atol=1e-4)


def _jax_compacted(sdf, pos, cct, ids):
    """JAX's triangles of one chunk from the same lattice values: the cell
    gather, marching_tets_cells and the padding mask of
    nerfloam_tpu/map/mesher.py:74-82, compacted on the host as
    mesher.py:113-114 does."""
    B, ncell = sdf.shape[0], cct.shape[0]
    tris, valid = jmarch.marching_tets_cells(jnp.asarray(pos[:, cct].reshape(B * ncell, 8, 3)),
                                             jnp.asarray(sdf[:, cct].reshape(B * ncell, 8)))
    valid = valid & (jnp.asarray(ids).repeat(ncell)[:, None] >= 0)
    return np.asarray(tris)[np.asarray(valid)]


@pytest.mark.parametrize("case", ["res 2", "res 4", "empty"])
def test_marching_tets_compact_equals_jax_host_compaction(jax_run, case):
    """K10b's compact form (its plain twin here) gives exactly JAX's
    ``np.asarray(tris)[np.asarray(valid)]`` on the same lattice values, in
    its order, with -1 padding voxels; an all-padding chunk gives T = 0."""
    slam, tm, tcfg, tparams = jax_run
    res = 4 if case == "res 4" else 2
    ids = jmesher.vm.surface_snapshot(slam.state.map_state)["voxel_ids"][:200]
    padded = np.full(256, -1, np.int32)
    if case != "empty":
        padded[: len(ids)] = ids
    sdf, pos, cct, tids = tmesher._chunk_lattice(tm, tcfg, tparams, torch.as_tensor(padded), res,
                                                 slam.compute_dtype)
    want = _jax_compacted(sdf.numpy(), pos.numpy(), cct.numpy(), padded)
    tris, T = tmarch.marching_tets_compact(sdf, pos, cct, tids)
    assert T.dtype == torch.int32 and T.shape == () and int(T) == len(want)
    np.testing.assert_array_equal(tris[:int(T)].numpy(), want)
    if case == "empty":
        assert int(T) == 0
    else:
        assert int(T) > 100
        ptris, pvalid = tmarch.marching_tets_lattice(sdf, pos, cct, tids)
        assert torch.equal(tris, ptris[pvalid])


def test_marching_wrappers_reject_what_they_would_convert():
    """Both forms of K10b take their inputs as they are, on the CPU too:
    another dtype, a strided tensor or a shape other than (B, S, 3) /
    (ncell, 8) / (B,) raises instead of being cast or copied."""
    g = torch.Generator().manual_seed(0)
    sdf = torch.randn((6, 8), generator=g)
    pos = torch.rand((6, 8, 3), generator=g)
    cct = torch.as_tensor(tmesher._cell_corner_table(2))
    ids = torch.arange(6, dtype=torch.int32)
    ok = dict(sdf=sdf, pos=pos, cct=cct, voxel_ids=ids)
    for key, value, match in (("sdf", sdf.double(), "sdf must be a contiguous"),
                              ("sdf", sdf.t().contiguous().t(), "sdf must be a contiguous"),
                              ("pos", pos[:, :, [0, 1, 2]].transpose(1, 2).contiguous()
                               .transpose(1, 2), "pos must be a contiguous"),
                              ("pos", pos[:, :4].contiguous(), "pos has shape"),
                              ("cct", cct.long(), "cct must be a contiguous"),
                              ("voxel_ids", ids.long(), "voxel_ids must be a contiguous"),
                              ("voxel_ids", ids[:5], "voxel_ids has shape")):
        for fn in (tmarch.marching_tets_lattice, tmarch.marching_tets_compact):
            with pytest.raises(ValueError, match=match):
                fn(**{**ok, key: value})


def test_extract_mesh_matches_jax(jax_run):
    slam, tm, tcfg, tparams = jax_run
    jv, jf = slam.extract_mesh(clean=False)
    tv, tf = tmesher.extract_mesh(tm, tcfg, tparams, res=slam.mesh_res,
                                  compute_dtype=slam.compute_dtype)
    assert len(jf) > 1000
    assert tv.shape == jv.shape and tf.shape == jf.shape
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    from scipy.spatial import cKDTree

    d, _ = cKDTree(jv).query(tv)
    assert d.max() <= 1e-5, d.max()
    d, _ = cKDTree(tv).query(jv)
    assert d.max() <= 1e-5, d.max()
    # no degenerate face, every index in range
    assert tf.min() >= 0 and tf.max() < len(tv)
    assert ((tf[:, 0] != tf[:, 1]) & (tf[:, 1] != tf[:, 2]) & (tf[:, 0] != tf[:, 2])).all()
    # small chunks give the same mesh: duplicate vertices across chunks weld
    tv2, tf2 = tmesher.extract_mesh(tm, tcfg, tparams, res=slam.mesh_res,
                                    compute_dtype=slam.compute_dtype, chunk_cells=97)
    np.testing.assert_array_equal(tv2, tv)
    np.testing.assert_array_equal(tf2, tf)


def test_surface_snapshot_equal_jax(jax_run):
    from nerfloam_tpu_torch.map import voxel_map as tvm

    slam, tm, _, _ = jax_run
    js = jmesher.vm.surface_snapshot(slam.state.map_state)
    ts = tvm.surface_snapshot(tm)
    assert ts["num_lat"] == js["num_lat"]
    for k in ("voxel_ids", "coords", "corner_idx"):
        np.testing.assert_array_equal(ts[k], js[k])


def test_host_mesh_functions_equal_jax(jax_run):
    slam = jax_run[0]
    v, f = slam.extract_mesh(clean=False)
    obs = slam.observed_points()
    np.testing.assert_array_equal(tmesher.downsample_points(obs, 0.3),
                                  jmesher.downsample_points(obs, 0.3))
    kept_j = jmesher.clean_mesh(v, f, obs, radius=0.1)
    kept_t = tmesher.clean_mesh(v, f, obs, radius=0.1)
    np.testing.assert_array_equal(kept_t, kept_j)
    assert 0 < len(kept_t) < len(f)
    sj = jev.sample_mesh_surface(v, kept_j, 5000, seed=3)
    stt = tev.sample_mesh_surface(v, kept_t, 5000, seed=3)
    np.testing.assert_array_equal(stt, sj)
    gt = obs[::3]
    assert tev.mesh_metrics(stt, gt, f_threshold=0.2) == jev.mesh_metrics(sj, gt, f_threshold=0.2)
    np.testing.assert_array_equal(tev.crop_to_observed(gt, obs[:500], 0.5),
                                  jev.crop_to_observed(gt, obs[:500], 0.5))
    assert len(tev.sample_mesh_surface(v, f[:0])) == 0


def test_ply_and_observed_gt_equal_jax(tmp_path, jax_run):
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from eval_replica import observed_gt_cloud as j_observed

    slam = jax_run[0]
    v, f = slam.extract_mesh(clean=False)
    tlogger.write_ply(str(tmp_path / "t.ply"), v, f)
    jlogger.write_ply(str(tmp_path / "j.ply"), v, f)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    rv, rf = tlogger.read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(rv, v)
    np.testing.assert_array_equal(rf, f)
    np.testing.assert_array_equal(tev.observed_gt_cloud(slam.dataset, stride=2, per_frame=500),
                                  j_observed(slam.dataset, stride=2, per_frame=500))
