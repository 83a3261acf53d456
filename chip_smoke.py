#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Refuses to run without CUDA. Prints the card's name and power limit.
2. Builds the port's kernels (nerfloam_tpu_torch/csrc/*.cu) with nvcc and
   prints the build seconds.
3. Kernel phase: K4 (hit table), K1 (hits field) and K2 (its backward)
   against their plain torch versions on the card, at the KITTI-budget
   shapes, on a map built by inserting the first frames of the synthetic
   world. Prints each kernel's max error and median time (CUDA events).
4. Main path: the KITTI-budget config (nerfloam_tpu_torch/configs/
   kitti_budget.json, 30 frames) through NerfLoamSLAM_torch on the card:
   process_first_frame, 29 x process_frame, finalize. Prints scans/s over
   frames 6-29, each kernel's launches per frame, the overflow counters
   and the ATE against ground truth, and checks them.

Any failure raises (exit code 1). The last two lines of standard output
are the kernels' JSON record and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from nerfloam_tpu.data import get_dataset
from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core import render
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.core.tracking import _ray_dirs, t_cap_for
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.ops import raycast, se3
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices
from nerfloam_tpu_torch.utils.config import load_json_config

# ATE (m, no alignment) of the JAX package on the same config and frame
# count, measured on a CPU from a checkout of the JAX package:
#   cfg = load_config("configs/synthetic/synthetic_small.yaml",
#                     bench.BENCH_OVERRIDES + ["data_specs.n_frames=30",
#                                              "tpu_specs.defer_sync=false"])
#   slam = NerfLoamSLAM(cfg, get_dataset(cfg)); frames as in bench.py;
#   slam.process_first_frame(frames[0]); slam.process_frame(f) for f in frames[1:];
#   evaluation.ate_rmse(np.asarray(slam.finalize()), gt, align=False)
ATE_JAX = 2.0099257979398644
ATE_BOUND = max(1.5 * ATE_JAX, ATE_JAX + 0.05)
WARMUP_FRAMES = 6
TIMED_RUNS = 20


def log(*a):
    print(*a, flush=True)


def median_ms(fn, n=TIMED_RUNS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_phase(slam, ds):
    """K4, K1, K2 against their plain versions at the bench shapes."""
    dev = slam.device
    cfg, rc_t, rc_m = slam.map_cfg, slam.rc_track, slam.rc_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    frames = []
    for i in range(4):
        idx, pts, cos, _ = ds[i]
        f = Frame.from_raw(idx, pts, cos, ds.get_init_pose(i), slam.points_pad)
        frames.append(f)
    ms = vm.create(cfg, dev)
    ms = vm.recenter(ms, cfg, torch.as_tensor(frames[0].pose6[:3], device=dev))
    for f in frames:
        p, c, v = f.device_arrays(dev)
        ms = vm.insert_frame(ms, cfg, p, c, v, torch.as_tensor(f.pose6, device=dev),
                             slam.insert_cand_cap)
    emb = (torch.randn(ms.embeddings.shape, generator=gen, device=dev) * 0.1)
    ms = vm.refresh_active(ms._replace(embeddings=emb.to(ms.embeddings.dtype)), cfg)
    n_active = int(ms.n_active)
    log(f"[kernels] map: {int(ms.num_lat)} lattice rows, {n_active} active voxels "
        f"(A={ms.packed.shape[0]}), grid {cfg.grid_dim}")

    p, c, v = frames[0].device_arrays(dev)
    pose = torch.as_tensor(pose6_from_matrix_np(ds.get_init_pose(0)), device=dev)

    def rays(n):
        idx, _ = sample_ray_indices(v, n, gen)
        pts, pcos = p[idx], c[idx]
        d = se3.rotate_dirs(pose, _ray_dirs(pts))
        o = se3.pose_translation(pose).expand_as(d).contiguous()
        return o, d.contiguous(), t_cap_for(pts, pcos, 0.3, rc_t.max_depth)

    records = []

    # ---- K4 at the tracker (R=2048) and BA superset (R=4096) shapes
    worst_t = worst_cdf = 0.0
    tables = {}
    for R in (slam.tp.n_rays, 2 * slam.bp_current.n_rays):
        o, d, tc = rays(R)
        ker = raycast.build_hit_table(ms, cfg, rc_t, o, d, tc)
        ref = raycast.build_hit_table_plain(ms, cfg, rc_t, o, d, tc)
        torch.cuda.synchronize()
        check(torch.equal(ker.aid, ref.aid), f"K4 aid differs (R={R})")
        check(torch.equal(ker.cell, ref.cell), f"K4 cell differs (R={R})")
        check(torch.equal(ker.ray_mask, ref.ray_mask), f"K4 ray_mask differs (R={R})")
        e_t = max(max_abs(ker.t_near, ref.t_near), max_abs(ker.seg, ref.seg))
        e_c = float(((ker.cdf - ref.cdf).abs() / ref.cdf.abs().clamp(min=1e-6)).max())
        check(e_t <= 1e-6, f"K4 t_near/seg error {e_t}")
        check(e_c <= 1e-5, f"K4 cdf rel error {e_c}")
        worst_t, worst_cdf = max(worst_t, e_t), max(worst_cdf, e_c)
        tables[R] = (o, d, tc, ref)
        hits = float((ref.aid >= 0).sum(1).float().mean())
        log(f"[K4] R={R}: mean hits/ray {hits:.2f}, ray hit rate "
            f"{float(ref.ray_mask.float().mean()):.3f}, t/seg err {e_t:.3g}, cdf rel err {e_c:.3g}")
    o, d, tc, _ = tables[2 * slam.bp_current.n_rays]
    k_ms = median_ms(lambda: raycast.build_hit_table(ms, cfg, rc_t, o, d, tc))
    p_ms = median_ms(lambda: raycast.build_hit_table_plain(ms, cfg, rc_t, o, d, tc))
    log(f"[K4] R={o.shape[0]} S={raycast._coarse_shape(rc_t)[1]} H={rc_t.max_hits}: "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    records.append({"name": "hit_table", "route": "cuda",
                    "source": "nerfloam_tpu_torch/csrc/hit_table.cu",
                    "replaces": "nerfloam_tpu/ops/raycast.py:159",
                    "max_abs_err": max(worst_t, worst_cdf), "ms": k_ms, "plain_ms": p_ms})

    # ---- K1 / K2 at the tracker (M=64) and BA (M=48) shapes, with the
    # origin moved 1 cm off the table's so samples re-resolve
    e1 = e2p = 0.0
    times = {}
    for name, R, M in (("track", slam.tp.n_rays, rc_t.n_samples),
                       ("ba", slam.bp_current.n_rays, rc_m.n_samples)):
        o, d, tc, ht = tables[slam.tp.n_rays] if name == "track" else tables[2 * R]
        ht = raycast.HitTable(*[x[:R] for x in ht])
        o, d = (o[:R] + 0.01).contiguous(), d[:R].contiguous()
        u = raycast.uniform_jitter((R, M), gen, dev)
        ker = render.hits_field_fwd(ht, u, o, d, ms.packed, cfg.voxel_size)
        ref = render.hits_field_fwd_plain(ht, u, o, d, ms.packed, cfg.voxel_size)
        torch.cuda.synchronize()
        for i, nm in enumerate(("z", "valid", "aid", "xyz")):
            check(torch.equal(ker[i], ref[i]), f"K1 {nm} differs ({name})")
        ef = max_abs(ker[4], ref[4])
        check(ef <= 1e-6, f"K1 feats error {ef} ({name})")
        e1 = max(e1, ef)
        valid, aid, xyz = ref[1], ref[2], ref[3]
        dfeats = torch.randn((R, M, 16), generator=gen, device=dev)
        kx, kp = render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size)
        rx, rp = render.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed,
                                             cfg.voxel_size, True)
        torch.cuda.synchronize()
        ex = max_abs(kx, rx) / max(float(rx.abs().max()), 1e-30)
        ep = max_abs(kp, rp)
        check(ex <= 1e-5, f"K2 d xyz rel error {ex} ({name})")
        check(ep <= 1e-5 * float(rp.abs().max()), f"K2 d packed error {ep} ({name})")
        e2p = max(e2p, ep)
        log(f"[K1/K2] {name} R={R} M={M}: valid {float(valid.float().mean()):.3f}, "
            f"feats err {ef:.3g}, dxyz rel err {ex:.3g}, dpacked err {ep:.3g} "
            f"(max |dpacked| {float(rp.abs().max()):.3g}, rows {kp.shape[0]})")
        times[name] = (
            median_ms(lambda: render.hits_field_fwd(ht, u, o, d, ms.packed, cfg.voxel_size)),
            median_ms(lambda: render.hits_field_fwd_plain(ht, u, o, d, ms.packed,
                                                          cfg.voxel_size)),
            median_ms(lambda: render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed,
                                                    cfg.voxel_size)),
            median_ms(lambda: render.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed,
                                                          cfg.voxel_size, True)),
        )
        log(f"[K1/K2] {name}: fwd kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms;"
            f" bwd kernel {times[name][2]:.4f} ms, plain {times[name][3]:.4f} ms")
    k1, p1, k2, p2 = times["ba"]
    records.append({"name": "hits_field_fwd", "route": "cuda",
                    "source": "nerfloam_tpu_torch/csrc/hits_field.cu",
                    "replaces": "nerfloam_tpu/core/render.py:108",
                    "max_abs_err": e1, "ms": k1, "plain_ms": p1})
    records.append({"name": "hits_field_bwd", "route": "cuda",
                    "source": "nerfloam_tpu_torch/csrc/hits_field.cu",
                    "replaces": "nerfloam_tpu/core/ba.py:335",
                    "max_abs_err": e2p, "ms": k2, "plain_ms": p2})
    return records


def main_path(slam, ds):
    """30 frames of the KITTI-budget config through NerfLoamSLAM_torch."""
    frames = []
    for i in range(len(ds)):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    for f in frames:
        f.device_arrays(slam.device)

    raycast.hit_table_launches = 0
    render.hits_field_fwd_launches = 0
    render.hits_field_bwd_launches = 0
    t_start = time.perf_counter()
    slam.process_first_frame(frames[0])
    for f in frames[1:WARMUP_FRAMES]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[WARMUP_FRAMES:]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    poses = np.asarray(slam.finalize())
    torch.cuda.synchronize()
    total = time.perf_counter() - t_start
    launches = {
        "hit_table": raycast.hit_table_launches,
        "hits_field_fwd": render.hits_field_fwd_launches,
        "hits_field_bwd": render.hits_field_bwd_launches,
    }
    n_timed = len(frames) - WARMUP_FRAMES
    scans = n_timed / dt
    gt = ds.gt_trajectory()[: len(poses)]
    ate = float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))))
    log(f"[main] {len(frames)} frames in {total:.2f} s (finalize included); "
        f"scans/s over frames {WARMUP_FRAMES}-{len(frames) - 1}: {scans:.4f}")
    log(f"[main] launches: {launches}; per frame ({len(frames)} frames + finalize): "
        + ", ".join(f"{k} {v / len(frames):.2f}" for k, v in launches.items()))
    log(f"[main] overflow events {slam.overflow_events}, dropped {slam.dropped_delta_events}, "
        f"host syncs {slam.host_syncs} ({slam.host_syncs / len(frames):.2f} per frame)")
    log(f"[main] sections (ms): " + json.dumps(
        {k: round(v["mean_ms"], 3) for k, v in slam.prof.summary().items()}))
    log(f"[main] ATE {ate:.4f} m (bound {ATE_BOUND:.4f} m from JAX {ATE_JAX:.4f} m); "
        f"final position {poses[-1][:3, 3].tolist()}, GT {gt[-1][:3, 3].tolist()}")
    ms = slam.state.map_state
    check(len(poses) == len(frames), f"{len(poses)} poses for {len(frames)} frames")
    check(np.isfinite(poses).all(), "non-finite pose")
    check(bool(torch.isfinite(ms.embeddings.float()).all()), "non-finite embeddings")
    check(all(bool(torch.isfinite(w).all()) for w in slam.state.decoder_params["w"]),
          "non-finite decoder")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} never launched on the main path")
    check(ate <= ATE_BOUND, f"ATE {ate} above bound {ATE_BOUND}")
    check(slam.dropped_delta_events == 0, "dropped deltas")
    return launches, scans


def profile_phase(cfg, ds, n_frames=8, n_profiled=3, device="cuda"):
    """torch.profiler over a few steady frames of a fresh run: device time
    by kernel and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    slam = NerfLoamSLAM_torch(cfg, ds, device=device)
    frames = []
    for i in range(n_frames):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    slam.process_first_frame(frames[0])
    for f in frames[1:-n_profiled]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[-n_profiled:]:
            slam.process_frame(f)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731
    total = sum(dev(e) for e in events)
    log(f"[profile] {n_profiled} frames: wall {wall_ms:.1f} ms (profiler on), device kernels "
        f"{total:.1f} ms, busy share {total / wall_ms:.3f}, {sum(e.count for e in events)} "
        f"kernel launches")
    for e in sorted(events, key=dev, reverse=True)[:15]:
        log(f"[profile] {dev(e) / n_profiled:9.3f} ms/frame  {e.count / n_profiled:8.1f}/frame  "
            f"{e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_info.get('seconds', 0.0):.2f} s)")
    for line in kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    cfg = load_json_config(os.path.join(here, "nerfloam_tpu_torch", "configs",
                                        "kitti_budget.json"))
    ds = get_dataset(cfg)
    records = kernel_phase(NerfLoamSLAM_torch(cfg, ds, device="cuda"), ds)
    slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    launches, scans = main_path(slam, ds)
    profile_phase(cfg, ds)
    for r in records:
        r["launches"] = launches[r["name"]]
    log(f"[result] scans/s {scans:.4f} on {smi}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
