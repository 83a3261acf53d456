"""ATE of the JAX package on the configs the PyTorch port runs in
chip_smoke.py, measured on the CPU: the reference its ATE bound is made of.

    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py            # kitti_budget.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality  # kitti_quality.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --adam25   # kitti_adam25.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality --s2s  # kitti_quality_s2s.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --gate60 SEED  # replica_gate60.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --adam25 --exact  # kitti_exact.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --knobs        # kitti_knobs.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --mapping-gt   # kitti_mapping_gt.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --decoder-pe   # kitti_decoder_pe.json
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality --defer  # kitti_quality_defer
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --defer --active-cap N  # ..._defer_grow
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality --subscene 10  # [subscene]
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --quality --kitti-dir DIR  # [loader]
    JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --dropped  # [knobs_dropped]

The KITTI-budget configs are synthetic_small.yaml + bench.BENCH_OVERRIDES
(+ QUALITY_OVERRIDES or ADAM25) + 30 frames, defer_sync off unless
``--defer``, i.e. the
port's JSON config of the same name; frames are fed as bench.py feeds
them. Prints one JSON line with the unaligned ATE RMSE (m) of the
finalized trajectory.

``--s2s`` adds the scan-to-scan term (``tpu_specs.s2s_weight=10.0``, image
64 x 1024) to the GN tracker of the chosen config.

ADAM25 is bench.ADAM25_OVERRIDES plus ``tpu_specs.track_method=adam``: the
pipeline reads the tracker choice from tpu_specs, so bench.py's
``tracker_specs.track_method=adam`` alone leaves the GN tracker on.

``--exact`` adds the reference-exact fallbacks to the chosen config
(``--adam25`` or ``--gate60 SEED``): f32 embeddings, exact embedding
gradients, BA without a ray superset and per-iteration tracker rays
(``EXACT``); ``--adam25 --exact`` is the port's kitti_exact.json.

``--knobs`` is the quality config with the off-by-default knobs on
(``KNOBS``: replay every 5 frames, BA's pose update kept off the motion
direction, back points dropped from the mapper's copy); it also prints
the replay steps taken before finalize, the largest |along| of the
BA-delta telemetry and the share of valid points the back-point rule
dropped. ``--mapping-gt`` is the quality config on ground-truth poses
(``data_specs.use_gt=true``: every frame mapping-only); it also prints
the map's row count and the mesh's triangles (welded, and after
clean_mesh). ``--decoder-pe`` is the budget config with a decoder skip
and the nerf positional embedder (``DECODER_PE``).

``--defer`` runs the chosen config under ``tpu_specs.defer_sync=true``
(the JAX package's default schedule: frame k dispatched before frame k-1
is finalized; ``--quality --defer`` is kitti_quality_defer.json) and also
prints the deferred replays (overflows found with a newer frame in
flight) and the keyframe count. ``--active-cap N`` sets
``tpu_specs.active_cap`` (``--defer --active-cap N`` on the budget config is
kitti_budget_defer_grow.json: an active set that grows mid-run).

``--dropped`` is the quality config over its first 10 frames with the
knobs the JAX package measured and dropped turned on (``DROPPED``:
``maturity_warmup`` 4, ``bias_source=keyframe``, ``bias_classes`` 2):
chip_smoke.py's ``[knobs_dropped]``.

``--tpu-seed N`` sets ``tpu_specs.seed`` (the random stream's seed; the
data's stays the config's).

``--subscene N`` runs the chosen config through the JAX package's
``parallel.subscene.SubsceneRunner``, N frames to a submap (chip_smoke.py's
``[subscene]``: ``--quality --subscene 10``), and also prints the submaps and
the mesh's size. ``--kitti-dir DIR`` writes the config's 30 scans into DIR
as a KITTI odometry directory (``chip_smoke.write_kitti_dir``: the files
chip_smoke.py's ``[loader]`` writes from the same config) unless DIR holds
one, and runs the config through ``NerfLoamSLAM.run()`` on the JAX package's
``kitti.DataLoader(DIR, max_depth=40, min_depth=2)``, whose default path
filters and segments each scan in C++; the ATE is taken against
DIR/poses_lidar.txt.

``--gate60 SEED`` runs the replica gate instead: kitti_replica_ci.yaml +
calibrate_gate60.GATE60 + LEAN + data_specs.seed=SEED, defer_sync off,
through NerfLoamSLAM.run() as scripts/eval_replica.py drives it, and
prints the raw and aligned ATE, the overflow accounting, the lateral
drift rate and each frame's raw translation error (m, no alignment: the
estimated position's distance to the ground truth's), with no mesh.
"""

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from nerfloam_tpu.core.frame import Frame, pose6_from_matrix_np  # noqa: E402
from nerfloam_tpu.core.pipeline import NerfLoamSLAM  # noqa: E402
from nerfloam_tpu.data import get_dataset  # noqa: E402
from nerfloam_tpu.utils import evaluation  # noqa: E402
from nerfloam_tpu.utils.config import load_config  # noqa: E402

ADAM25 = bench.ADAM25_OVERRIDES + ["tpu_specs.track_method=adam"]
S2S = ["tpu_specs.s2s_weight=10.0"]
KNOBS = ["tpu_specs.replay_freq=5", "tpu_specs.ba_pose_project=along",
         "mapper_specs.remove_back=true"]
MAPPING_GT = ["data_specs.use_gt=true"]
# load_config parses no list from an override ("[0]" stays a string), so the
# skips are set on the loaded config
DECODER_PE = ["decoder_specs.embedder=nerf", "decoder_specs.multires=4"]
DECODER_PE_SKIPS = [0]
DROPPED = ["tpu_specs.maturity_warmup=4", "tpu_specs.bias_source=keyframe",
           "tpu_specs.bias_classes=2"]
DROPPED_FRAMES = 10
EXACT = ["tpu_specs.emb_dtype=float32", "tpu_specs.exact_embedding_grads=true",
         "tpu_specs.ba_ray_superset=0", "tpu_specs.track_resample_rays=true"]


def gate60_overrides(seed: int) -> list:
    spec = importlib.util.spec_from_file_location(
        "calibrate_gate60", os.path.join(ROOT, "scripts", "calibrate_gate60.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GATE60 + mod.LEAN + [f"data_specs.seed={seed}", "tpu_specs.defer_sync=false"]


def drift_lat_cm_f(est: np.ndarray, gt: np.ndarray) -> float:
    """Mean lateral per-frame drift (cm/frame), scripts/eval_replica.py:99-111."""
    rel_e = np.linalg.inv(est[:-1]) @ est[1:]
    rel_g = np.linalg.inv(gt[:-1]) @ gt[1:]
    diff = rel_e[:, :3, 3] - rel_g[:, :3, 3]
    fwd = rel_g[:, :3, 3] / (np.linalg.norm(rel_g[:, :3, 3], axis=1, keepdims=True) + 1e-9)
    along = np.einsum("ij,ij->i", diff, fwd)
    return float(np.linalg.norm(diff - along[:, None] * fwd, axis=1).mean()) * 100


def gate60(seed: int, exact: bool = False, extra=()):
    cfg = load_config(os.path.join(ROOT, "configs", "synthetic", "kitti_replica_ci.yaml"),
                      gate60_overrides(seed) + (EXACT if exact else []) + list(extra))
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM(cfg, ds)
    t0 = time.perf_counter()
    est = np.asarray(slam.run())
    gt = ds.gt_trajectory()[: len(est)]
    print(json.dumps({
        "config": "replica_gate60" + ("_exact" if exact else ""),
        "seed": seed,
        "tpu_seed": int(cfg.tpu_specs["seed"]),
        "frames": len(est),
        "ate_raw_m": evaluation.ate_rmse(est, gt, align=False),
        "ate_aligned_m": evaluation.ate_rmse(est, gt, align=True),
        "growth_events": int(sum(slam.overflow_events.values())),
        "overflow_events": {k: int(v) for k, v in slam.overflow_events.items()},
        "dropped_delta_events": int(slam.dropped_delta_events),
        "drift_lat_cm_f": drift_lat_cm_f(est, gt),
        "frame_err_m": [float(e) for e in np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)],
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(),
    }))


def subscene(cfg, ds, n):
    """The JAX package's chained submaps, ``n`` frames to a submap."""
    from nerfloam_tpu.parallel.subscene import SubsceneRunner

    t0 = time.perf_counter()
    poses, (verts, faces), n_sub = SubsceneRunner(cfg, ds, frames_per_subscene=n).run()
    poses = np.asarray(poses)
    gt = ds.gt_trajectory()[: len(poses)]
    print(json.dumps({
        "config": "kitti_quality_subscene", "frames_per_subscene": n, "subscenes": n_sub,
        "frames": len(poses), "ate_m": float(evaluation.ate_rmse(poses, gt, align=False)),
        "mesh_vertices": int(len(verts)), "mesh_faces": int(len(faces)),
        "seconds": time.perf_counter() - t0, "backend": jax.default_backend(),
    }))


def kitti_dir(cfg, ds, path):
    """The config's scans written as a KITTI directory and read back through
    the JAX package's KITTI loader (its native C++ path)."""
    import chip_smoke
    from nerfloam_tpu.data import kitti

    if not os.path.isdir(os.path.join(path, "velodyne")):
        chip_smoke.write_kitti_dir(ds, path)
    kds = kitti.DataLoader(path, max_depth=40.0, min_depth=2.0)
    gt = np.loadtxt(os.path.join(path, "poses_lidar.txt")).reshape(-1, 3, 4)
    gt = np.concatenate([gt, np.tile([[[0.0, 0.0, 0.0, 1.0]]], (len(gt), 1, 1))], 1)
    slam = NerfLoamSLAM(cfg, kds)
    t0 = time.perf_counter()
    poses = np.asarray(slam.run())
    print(json.dumps({
        "config": "kitti_quality_kitti_dir", "frames": len(poses),
        "ate_m": float(evaluation.ate_rmse(poses, gt[: len(poses)], align=False)),
        "sdf_bias": [float(x) for x in slam.sdf_bias],
        "overflow_events": {k: int(v) for k, v in slam.overflow_events.items()},
        "seconds": time.perf_counter() - t0, "backend": jax.default_backend(),
    }))


def main():
    exact = "--exact" in sys.argv
    extra = ([f"tpu_specs.seed={int(sys.argv[sys.argv.index('--tpu-seed') + 1])}"]
             if "--tpu-seed" in sys.argv else [])
    if "--gate60" in sys.argv:
        return gate60(int(sys.argv[sys.argv.index("--gate60") + 1]), exact, extra)
    knobs = "--knobs" in sys.argv
    mapping_gt = "--mapping-gt" in sys.argv
    decoder_pe = "--decoder-pe" in sys.argv
    dropped = "--dropped" in sys.argv
    quality = "--quality" in sys.argv or knobs or mapping_gt or dropped
    adam25 = "--adam25" in sys.argv
    s2s = "--s2s" in sys.argv
    defer = "--defer" in sys.argv
    if "--active-cap" in sys.argv:
        extra.append(f"tpu_specs.active_cap={int(sys.argv[sys.argv.index('--active-cap') + 1])}")
    overrides = (bench.BENCH_OVERRIDES + (bench.QUALITY_OVERRIDES if quality else [])
                 + (ADAM25 if adam25 else []) + (S2S if s2s else []) + (EXACT if exact else [])
                 + (KNOBS if knobs else []) + (MAPPING_GT if mapping_gt else [])
                 + (DECODER_PE if decoder_pe else [])
                 + ["data_specs.n_frames=30", f"tpu_specs.defer_sync={str(defer).lower()}"]
                 + (DROPPED + [f"data_specs.n_frames={DROPPED_FRAMES}"] if dropped else [])
                 + extra)
    cfg = load_config(os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml"),
                      overrides)
    if decoder_pe:
        cfg.decoder_specs["skips"] = list(DECODER_PE_SKIPS)
    ds = get_dataset(cfg)
    if "--subscene" in sys.argv:
        return subscene(cfg, ds, int(sys.argv[sys.argv.index("--subscene") + 1]))
    if "--kitti-dir" in sys.argv:
        return kitti_dir(cfg, ds, sys.argv[sys.argv.index("--kitti-dir") + 1])
    slam = NerfLoamSLAM(cfg, ds)
    frames = []
    for i in range(len(ds)):
        idx, pts, cos, pose = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, pose, slam.points_pad,
                                     has_gt_pose=pose is not None))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    replays, back = [0], [0, 0]
    if knobs:
        replay = slam._replay

        def counted_replay(n_calls):
            replays[0] += n_calls
            return replay(n_calls)

        slam._replay = counted_replay
        without_back = Frame.without_back_points

        def counted_without_back(f, key_distance):
            out = without_back(f, key_distance)
            back[0] += int(f.valid.sum()) - int(out.valid.sum())
            back[1] += int(f.valid.sum())
            return out

        Frame.without_back_points = counted_without_back
    t0 = time.perf_counter()
    slam.process_first_frame(frames[0])
    for f in frames[1:]:
        slam.process_frame(f)
    replay_steps = replays[0]
    poses = np.asarray(slam.finalize())
    gt = ds.gt_trajectory()[: len(poses)]
    name = ("kitti_knobs" if knobs else "kitti_mapping_gt" if mapping_gt
            else "kitti_quality_dropped" if dropped
            else "kitti_decoder_pe" if decoder_pe else "kitti_quality" if quality
            else "kitti_adam25" if adam25 else "kitti_budget")
    if defer:
        name += "_defer" + ("_grow" if "--active-cap" in sys.argv else "")
    out = {
        "config": name + ("_s2s" if s2s else "") + ("_exact" if exact else ""),
        "frames": len(poses),
        "ate_m": float(evaluation.ate_rmse(poses, gt, align=False)),
        "sdf_bias": [float(x) for x in slam.sdf_bias],
        "overflow_events": {k: int(v) for k, v in slam.overflow_events.items()},
        "seconds": time.perf_counter() - t0,
        "backend": jax.default_backend(),
    }
    if defer:
        out.update(defer_replays=int(slam._defer_replays), keyframes=len(slam.state.keyframes),
                   dropped_delta_events=int(slam.dropped_delta_events),
                   active_cap=int(slam.map_cfg.active_cap))
    if dropped:
        out.update(keyframes=len(slam.state.keyframes))
    if knobs:
        along = [abs(r[1]) for r in slam.state.ba_delta_telemetry]
        out.update(replay_steps=replay_steps, ba_delta_rows=len(along),
                   max_abs_along_m=max(along) if along else None,
                   remove_back_dropped=back[0] / max(back[1], 1))
    if mapping_gt:
        v, f = slam.extract_mesh(clean=False)
        out.update(num_lat=int(slam.state.map_state.num_lat), mesh_vertices=int(len(v)),
                   mesh_triangles=int(len(f)),
                   mesh_triangles_clean=int(len(slam.extract_mesh(clean=True)[1])))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
