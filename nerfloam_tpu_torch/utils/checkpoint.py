"""Checkpoint and resume (port of nerfloam_tpu/utils/checkpoint.py).

The whole SLAM state (lattice map, embeddings, decoder, keyframes,
trajectory bookkeeping, budgets grown on overflow, random states) is flat
arrays and lists, saved as one ``state.npz`` plus a ``manifest.json`` and
restored exactly. The npz keys and the manifest are the JAX package's, so a
directory written by either package loads here:

- ``torch_generator`` (the device generator's state bytes) takes the place
  of ``jax_key``. A file without it, or with the state of another device
  type, seeds the generator from the config instead.
- bfloat16 tables are stored as their uint16 bit pattern, listed under
  ``bf16_as_uint16`` in the manifest: numpy cannot name the type, so an
  ``ml_dtypes`` array comes back as 2-byte void records, which is how a
  file written by the JAX package arrives and is read here too.
- a save drains the frame in flight first (``defer_sync``), and writes
  the device pose recurrence of the deferred schedule (``dev_last_pose6``,
  ``dev_prev_pose6``: the raw tracked poses of the last two dispatched
  frames, NaN where there are none, as the JAX package writes them). A
  load restores both where they are finite, else the next dispatch seeds
  them from the host poses, and leaves nothing in flight.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerfloam_tpu_torch.core.frame import Frame
from nerfloam_tpu_torch.map import voxel_map as vm

# Per-frame active-set views are derived state (rebuilt by refresh_active
# from the canonical table) and are not checkpointed.
DERIVED_MAP_FIELDS = ("active_ids", "n_active", "grid_active", "packed", "active_coords")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """An npz array as a tensor of ``dtype``; 2-byte records (uint16 from
    the port, void from ml_dtypes) holding bfloat16 bits are reinterpreted."""
    a = np.array(a)  # a contiguous copy that keeps 0-d shapes
    if a.dtype.itemsize == 2 and a.dtype.kind in "uV":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _pose6_or_nan(t) -> np.ndarray:
    return (np.full(6, np.nan, np.float32) if t is None
            else t.detach().cpu().numpy().astype(np.float32))


def save_checkpoint(path: str, slam) -> None:
    # a checkpoint holds a caught-up frame loop, or resume would redo the frame in flight
    slam._drain()
    os.makedirs(path, exist_ok=True)
    st = slam.state
    # Align the live state with what load will rebuild: the frame loop's
    # active views predate the frame's voxel insert, while load re-derives
    # them from the post-insert table. Refreshing here makes
    # save-and-continue bit-identical to save-and-resume.
    st.map_state = vm.refresh_active(st.map_state, slam.map_cfg)
    arrays, bf16 = {}, []
    for name in st.map_state._fields:
        if name in DERIVED_MAP_FIELDS:
            continue
        t = getattr(st.map_state, name)
        arrays[f"map_{name}"] = _to_numpy(t)
        if t.dtype == torch.bfloat16:
            bf16.append(f"map_{name}")
    ws, bs = st.decoder_params["w"], st.decoder_params["b"]
    for i in range(len(ws) - 1):
        arrays[f"dec_w{i}"] = _to_numpy(ws[i])
        arrays[f"dec_b{i}"] = _to_numpy(bs[i])
    arrays["dec_out_w"] = _to_numpy(ws[-1])
    arrays["dec_out_b"] = _to_numpy(bs[-1])
    if "gaussian_B" in st.decoder_params:
        arrays["dec_gaussian_B"] = _to_numpy(st.decoder_params["gaussian_B"])
    for i, kf in enumerate(st.keyframes):
        arrays[f"kf{i}_points"] = kf.points
        arrays[f"kf{i}_cos"] = kf.points_cos
        arrays[f"kf{i}_valid"] = kf.valid
        arrays[f"kf{i}_pose6"] = kf.pose6

    def stack44(mats):
        return np.asarray(mats).reshape(-1, 4, 4) if len(mats) else np.zeros((0, 4, 4))

    np.savez_compressed(
        os.path.join(path, "state.npz"),
        **arrays,
        final_poses=stack44(st.final_poses),
        fp_kf_idx=np.asarray([i for i, _ in st.frame_poses], np.int64),
        fp_rel=stack44([r for _, r in st.frame_poses]),
        tracking_traj=stack44(st.tracking_trajectory),
        frame_telemetry=np.asarray(st.frame_telemetry, np.float64).reshape(-1, 4),
        ba_delta_telemetry=np.asarray(st.ba_delta_telemetry, np.float64).reshape(-1, 4),
        last_pose6=st.last_frame.pose6 if st.last_frame else np.zeros(6),
        rel_pose=st.rel_pose if st.rel_pose is not None else np.eye(4),
        # defer_sync's device pose recurrence, exact: the host reseed goes through
        # a float64 matrix and would not repeat the uninterrupted run's digits
        dev_last_pose6=_pose6_or_nan(slam._dev_last_pose6),
        dev_prev_pose6=_pose6_or_nan(slam._dev_prev_pose6),
        # random states: resume is bit-reproducible against an uninterrupted run
        torch_generator=slam.generator.get_state().numpy(),
        py_rng=np.asarray(slam.pyrng.getstate()[1], np.uint32),
    )
    manifest = {
        "map_cfg": slam.map_cfg._asdict(),
        "n_keyframes": len(st.keyframes),
        "kf_indices": [kf.index for kf in st.keyframes],
        "kf_n_points": [kf.n_points for kf in st.keyframes],
        "current_keyframe": next(
            (i for i, kf in enumerate(st.keyframes) if kf is st.current_keyframe), -1),
        "first_frame_id": st.first_frame_id,
        "frames_processed": st.frames_processed,
        "has_rel_pose": st.rel_pose is not None,
        "last_frame_index": st.last_frame.index if st.last_frame else -1,
        "py_rng_version": slam.pyrng.getstate()[0],
        "sdf_bias": np.asarray(slam.sdf_bias, np.float64).reshape(-1).tolist(),
        # budgets grown on overflow: persisting them keeps resume bit-stable
        # (a resume at the small defaults would replay the growth)
        "touched_cap": int(slam.bp_current.touched_cap),
        "touched_cap_random": int(slam.bp_random.touched_cap),
        "insert_cand_cap": int(slam.insert_cand_cap),
        "bf16_as_uint16": bf16,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint(path: str, slam) -> None:
    """Restore ``slam`` (constructed from the run's config) from a
    checkpoint directory written by this package or by the JAX package."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "state.npz"))
    dev = slam.device
    mc = manifest["map_cfg"]
    slam.map_cfg = vm.MapConfig(
        capacity=int(mc["capacity"]),
        grid_dim=tuple(mc["grid_dim"]),
        voxel_size=float(mc["voxel_size"]),
        feat_dim=int(mc["feat_dim"]),
        emb_dtype=mc["emb_dtype"],
        active_cap=int(mc.get("active_cap", 0)),
        support_dist=float(mc.get("support_dist", 0.0)),
        support_sym=bool(mc.get("support_sym", False)),
    )
    st = slam.state
    fresh = vm.create(slam.map_cfg, dev)  # derived views start as placeholders
    st.map_state = fresh._replace(**{
        name: _to_tensor(data[f"map_{name}"], getattr(fresh, name).dtype, dev)
        for name in vm.MapState._fields
        if f"map_{name}" in data and name not in DERIVED_MAP_FIELDS})
    # rebuild the per-frame active views from the canonical table
    st.map_state = vm.refresh_active(st.map_state, slam.map_cfg)
    n_layers = len(st.decoder_params["w"])
    names = [(f"dec_w{i}", f"dec_b{i}") for i in range(n_layers - 1)] + [("dec_out_w", "dec_out_b")]
    dec = {
        "w": [_to_tensor(data[w], torch.float32, dev) for w, _ in names],
        "b": [_to_tensor(data[b], torch.float32, dev) for _, b in names],
    }
    if "dec_gaussian_B" in data:
        dec["gaussian_B"] = _to_tensor(data["dec_gaussian_B"], torch.float32, dev)
    elif "gaussian_B" in st.decoder_params:  # a file without it keeps the config's, as JAX's
        dec["gaussian_B"] = st.decoder_params["gaussian_B"]
    st.decoder_params = dec

    st.keyframes = [
        Frame(index=manifest["kf_indices"][i], points=data[f"kf{i}_points"],
              points_cos=data[f"kf{i}_cos"], valid=data[f"kf{i}_valid"],
              n_points=manifest["kf_n_points"][i], pose6=data[f"kf{i}_pose6"])
        for i in range(manifest["n_keyframes"])]
    cur = manifest["current_keyframe"]
    st.current_keyframe = st.keyframes[cur] if cur >= 0 else None
    st.final_poses = list(data["final_poses"])
    st.frame_poses = list(zip(data["fp_kf_idx"].tolist(), list(data["fp_rel"])))
    if "tracking_traj" in data:
        st.tracking_trajectory = list(data["tracking_traj"])
    if "frame_telemetry" in data:
        st.frame_telemetry = [tuple(r) for r in data["frame_telemetry"]]
    if "ba_delta_telemetry" in data:
        st.ba_delta_telemetry = [tuple(r) for r in data["ba_delta_telemetry"]]
    st.first_frame_id = manifest["first_frame_id"]
    st.frames_processed = manifest["frames_processed"]
    if manifest["last_frame_index"] >= 0:
        st.last_frame = Frame(index=manifest["last_frame_index"],
                              points=np.zeros((1, 3), np.float32),
                              points_cos=np.ones(1, np.float32), valid=np.zeros(1, bool),
                              n_points=0, pose6=data["last_pose6"])
    st.rel_pose = data["rel_pose"] if manifest["has_rel_pose"] else None

    gen_state = torch.from_numpy(data["torch_generator"].copy()) if "torch_generator" in data \
        else None
    if gen_state is not None and gen_state.numel() == slam.generator.get_state().numel():
        slam.generator.set_state(gen_state)
    else:  # a JAX checkpoint, or one written on another device type
        slam.generator.manual_seed(int(slam.cfg.tpu_specs["seed"]))
    if "py_rng" in data:
        inner = tuple(int(x) for x in data["py_rng"])
        slam.pyrng.setstate((manifest.get("py_rng_version", 3), inner, None))
    sb = np.asarray(manifest.get("sdf_bias", 0.0), np.float64).reshape(-1)
    # a scalar (old checkpoints) broadcasts into the (2,) per-class target
    slam.sdf_bias = (sb.astype(np.float32) if sb.size == 2
                     else np.full(2, sb.mean() if sb.size else 0.0, np.float32))
    # budgets grown on overflow; files without the keys keep the config's
    tc = int(manifest.get("touched_cap", 0))
    if tc > 0:
        acap = vm.acap(slam.map_cfg)
        slam.bp_current = slam.bp_current._replace(touched_cap=min(tc, acap))
        slam.bp_random = slam.bp_random._replace(
            touched_cap=min(int(manifest.get("touched_cap_random", tc)), acap))
    cc = int(manifest.get("insert_cand_cap", 0))
    if cc > 0:
        slam.insert_cand_cap = cc
    # defer_sync: nothing is in flight at a (drained) save; the device pose
    # recurrence comes back where the file has it, else the host reseeds it
    slam._inflight = slam._dev_last_pose6 = slam._dev_prev_pose6 = None
    if "dev_last_pose6" in data:
        dl = np.asarray(data["dev_last_pose6"], np.float32)
        dp = np.asarray(data["dev_prev_pose6"], np.float32)
        if np.isfinite(dl).all() and np.isfinite(dp).all():
            slam._dev_last_pose6 = _to_tensor(dl, torch.float32, dev)
            slam._dev_prev_pose6 = _to_tensor(dp, torch.float32, dev)
