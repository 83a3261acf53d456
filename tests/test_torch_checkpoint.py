"""The port's outputs on the CPU: bf16 tables and checkpoints, a
checkpoint written by the JAX package loaded into the port, and the mesh
interval's replay and keyframe-graph reset (the checkpoint roundtrip and
bit-stable resume: tests/test_torch_checkpoint_resume.py; a run with a
logger: tests/test_torch_checkpoint_logged.py; demo/run_torch.py on the
CPU with --resume: tests/test_torch_demo.py; their own files, so that the
test runner's workers can take them side by side). Everything compared
here is compared exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.map import voxel_map as tvm
from nerfloam_tpu_torch.utils import checkpoint as tckpt
from nerfloam_tpu_torch.utils.bridge import load_jax_checkpoint, to_numpy
from nerfloam_tpu_torch.utils.config import finalize
from nerfloam_tpu_torch.utils.logger import RunLogger, read_ply

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
SLICE = CANON + ["data_specs.n_frames=8", "tpu_specs.bootstrap_steps=3", "tpu_specs.sampler=hits",
                 "tpu_specs.track_method=gn", "tpu_specs.recenter_margin=8.0",
                 "tpu_specs.defer_sync=false", "tpu_specs.bias_correction=true"]
SAVED = [n for n in tvm.MapState._fields if n not in tckpt.DERIVED_MAP_FIELDS]


def _frames(slam, ds, ids):
    out = []
    for i in ids:
        idx, pts, cos, _ = ds[i]
        out.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    return out


def _start(slam, ds, last):
    first = _frames(slam, ds, [0])[0]
    first.pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    slam.process_first_frame(first)
    for f in _frames(slam, ds, range(1, last + 1)):
        slam.process_frame(f)


def _snapshot(slam):
    st = slam.state
    return {
        "map": {n: to_numpy(getattr(st.map_state, n)) for n in st.map_state._fields},
        "decoder": to_numpy(st.decoder_params),
        "keyframes": [(k.index, k.n_points, k.points.copy(), k.points_cos.copy(), k.valid.copy(),
                       k.pose6.copy()) for k in st.keyframes],
        "current": st.keyframes.index(st.current_keyframe),
        "generator": slam.generator.get_state().clone(),
        "pyrng": slam.pyrng.getstate(),
        "budgets": (slam.bp_current.touched_cap, slam.bp_random.touched_cap, slam.insert_cand_cap,
                    slam.map_cfg),
        "sdf_bias": slam.sdf_bias.copy(),
        "rel_pose": st.rel_pose.copy(),
        "last_pose6": st.last_frame.pose6.copy(),
        "last_index": st.last_frame.index,
        "frames_processed": st.frames_processed,
        "frame_poses": [(i, r.copy()) for i, r in st.frame_poses],
        "final_poses": [p.copy() for p in st.final_poses],
        "tracking": np.asarray(st.tracking_trajectory),
        "telemetry": np.asarray(st.frame_telemetry),
    }


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not hasattr(a, "_fields"):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_bf16_tables_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    t = torch.randn((64, 16), generator=g).to(torch.bfloat16)
    arr = tckpt._to_numpy(t)
    assert arr.dtype == np.uint16
    # the JAX package's bf16 table: an ml_dtypes array, which numpy stores as void records
    j = np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    np.savez_compressed(tmp_path / "t.npz", port=arr, jax=j, n=np.zeros((), np.int32))
    data = np.load(tmp_path / "t.npz")
    assert data["jax"].dtype.kind == "V"
    for key in ("port", "jax"):
        back = tckpt._to_tensor(data[key], torch.bfloat16, "cpu")
        assert back.dtype == torch.bfloat16 and torch.equal(back, t), key
    n = tckpt._to_tensor(data["n"], torch.int32, "cpu")
    assert n.shape == () and n.dtype == torch.int32


def test_bf16_checkpoint_roundtrip(tmp_path):
    cfg = finalize(load_config(CFG_PATH, SLICE + ["tpu_specs.emb_dtype=bfloat16"]).as_dict())
    ds = get_dataset(cfg)
    a = NerfLoamSLAM_torch(cfg, ds, device="cpu")
    _start(a, ds, 1)
    tckpt.save_checkpoint(str(tmp_path / "c"), a)
    b = NerfLoamSLAM_torch(cfg, ds, device="cpu")
    tckpt.load_checkpoint(str(tmp_path / "c"), b)
    assert b.state.map_state.embeddings.dtype == torch.bfloat16
    assert bool((b.state.map_state.embeddings != 0).any())
    _assert_same(_snapshot(a), _snapshot(b))
    with open(tmp_path / "c" / "manifest.json") as f:
        assert json.load(f)["bf16_as_uint16"] == ["map_embeddings"]


def test_jax_checkpoint_loads_into_port(tmp_path):
    from nerfloam_tpu.core.frame import Frame as JFrame
    from nerfloam_tpu.core.frame import pose6_from_matrix_np as j_pose6
    from nerfloam_tpu.core.pipeline import NerfLoamSLAM
    from nerfloam_tpu.utils.checkpoint import save_checkpoint as j_save

    cfg = load_config(CFG_PATH, SLICE)
    ds = get_dataset(cfg)
    js = NerfLoamSLAM(cfg, ds)
    frames = []
    for i in range(4):
        idx, pts, cos, _ = ds[i]
        frames.append(JFrame.from_raw(idx, pts, cos, None, js.points_pad))
    frames[0].pose6 = j_pose6(ds.get_init_pose(0))
    js.process_first_frame(frames[0])
    for f in frames[1:3]:
        js.process_frame(f)
    j_save(str(tmp_path / "jax"), js)

    slam = NerfLoamSLAM_torch(finalize(cfg.as_dict()), get_dataset(cfg), device="cpu")
    seeded = torch.Generator().manual_seed(int(cfg.tpu_specs["seed"])).get_state()
    load_jax_checkpoint(str(tmp_path / "jax"), slam)
    jm = jax.device_get(js.state.map_state)
    tm = to_numpy(slam.state.map_state)
    for n in SAVED:
        np.testing.assert_array_equal(getattr(tm, n), np.asarray(getattr(jm, n)), err_msg=n)
    assert int(tm.n_active) == int(jm.n_active) > 0                    # rebuilt on load
    np.testing.assert_array_equal(tm.active_ids, np.asarray(jm.active_ids))
    np.testing.assert_array_equal(tm.packed, np.asarray(jm.packed))
    jd = jax.device_get(js.state.decoder_params)
    layers = list(jd["layers"]) + [jd["out"]]
    for k in ("w", "b"):
        for t, j in zip(slam.state.decoder_params[k], layers):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j[k]))
    assert len(slam.state.keyframes) == len(js.state.keyframes) >= 1
    for tk, jk in zip(slam.state.keyframes, js.state.keyframes):
        assert (tk.index, tk.n_points) == (jk.index, jk.n_points)
        for n in ("points", "points_cos", "valid", "pose6"):
            np.testing.assert_array_equal(getattr(tk, n), getattr(jk, n))
    st = slam.state
    assert st.frames_processed == 3 and st.last_frame.index == 2
    assert st.keyframes.index(st.current_keyframe) == js.state.keyframes.index(
        js.state.current_keyframe)
    np.testing.assert_array_equal(st.last_frame.pose6, js.state.last_frame.pose6)
    np.testing.assert_array_equal(st.rel_pose, js.state.rel_pose)
    np.testing.assert_array_equal(slam.sdf_bias, np.asarray(js.sdf_bias, np.float32))
    assert len(st.frame_poses) == len(js.state.frame_poses) == 3
    assert slam.pyrng.getstate() == js.pyrng.getstate()
    assert (slam.bp_current.touched_cap, slam.insert_cand_cap) == (js.bp_current.touched_cap,
                                                                   js.insert_cand_cap)
    assert torch.equal(slam.generator.get_state(), seeded)   # jax_key is ignored: the config's seed
    # the loaded state tracks on: frame 3 lands near ground truth
    idx, pts, cos, _ = ds[3]
    slam.process_frame(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    gt = ds.gt_trajectory()[3][:3, 3]
    assert np.linalg.norm(st.last_frame.pose6[:3] - gt) < 0.3


def test_mesh_interval_replays_and_resets_keyframe_graph(tmp_path):
    # a tiny replay budget: the interval replays once per keyframe and once more
    cfg = finalize(load_config(CFG_PATH, SLICE + [
        "mapper_specs.window_size=1", "mapper_specs.N_rays_each=128",
        "mapper_specs.num_iterations=2", "tpu_specs.bootstrap_steps=1"]).as_dict())
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM_torch(cfg, ds, device="cpu", logger=RunLogger(str(tmp_path), "m"))
    _start(slam, ds, 0)
    st = slam.state
    assert slam.final_iter
    cur = st.current_keyframe
    st.keyframes = [cur] * 21                      # more than 20 keyframes: replay, then reset
    before = st.map_state.embeddings.clone()
    frame = Frame(index=8, points=cur.points, points_cos=cur.points_cos, valid=cur.valid,
                  n_points=cur.n_points, pose6=cur.pose6.copy())
    slam._mesh_interval(frame)
    assert st.keyframes == [cur]
    assert not torch.equal(before, st.map_state.embeddings)            # the replay trained
    v, _ = read_ply(os.path.join(slam.logger.dir, "mesh", "mesh_00008.ply"))
    assert np.isfinite(v).all()        # (a field this little trained may cross zero nowhere)
    assert os.path.isfile(os.path.join(slam.logger.dir, "misc", "frame_poses_00008.npy"))
    assert st.frame_poses == []                                        # flushed into final_poses
