#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Refuses to run without CUDA. Prints the card's name and power limit.
2. Builds the port's kernels (nerfloam_tpu_torch/csrc/*.cu), one nvcc per
   source, all at once, and prints the build seconds.
3. Kernel phase, at the shapes of the quality-stack config on a map built
   by inserting the first frames of the synthetic world with support
   voxels: K4 (hit table), K1 (hits field), K2 (its backward), K8 (active
   field: band columns and the bias probe), K3 (GN normal equations) and
   K7 (voxel insert) against their plain torch versions on the card.
   Prints each kernel's max error, its median time and its twin's (CUDA
   events), the least time the card could take (bound) and, for K3, the
   torch.einsum pair that computes the same H and b.
4. Main paths, 30 frames each through NerfLoamSLAM_torch on the card
   (process_first_frame, 29 x process_frame, finalize):
   - the KITTI-budget config (nerfloam_tpu_torch/configs/kitti_budget.json);
   - the quality stack (configs/kitti_quality.json: support voxels both
     sides, 8 band samples, bias transfer).
   Each path's launch counts are zeroed just before it and read just
   after. Prints scans/s over frames 6-29, sections, host syncs, overflow
   counters, the final sdf_bias and the ATE against ground truth, and
   checks them: every kernel of the path launched, no drops, ATE in bound.
5. A torch.profiler breakdown of a few steady quality frames.

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

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core import render
from nerfloam_tpu_torch.core import tracking as tr
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.core.tracking import _ray_dirs, t_cap_for
from nerfloam_tpu_torch.data import get_dataset
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.ops import raycast, se3
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices
from nerfloam_tpu_torch.utils.config import load_json_config

# ATE (m, no alignment) of the JAX package on the same config and frame
# count, measured on a CPU from a checkout of the JAX package:
#   JAX_PLATFORMS=cpu python scripts/port_ate_reference.py [--quality]
# (synthetic_small.yaml + bench.BENCH_OVERRIDES [+ QUALITY_OVERRIDES],
# 30 frames, defer_sync off, frames fed as bench.py feeds them, then
# evaluation.ate_rmse(finalize(), gt, align=False))
ATE_JAX = {"kitti_budget": 2.0099257979398644, "kitti_quality": 1.4708145094137826}
WARMUP_FRAMES = 6
TIMED_RUNS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
PATH_KERNELS = {           # kernels each main path must launch
    "kitti_budget": ("hit_table", "hits_field_fwd", "hits_field_bwd", "gn_system", "insert"),
    "kitti_quality": ("hit_table", "hits_field_fwd", "hits_field_bwd", "gn_system", "insert",
                      "active_field_fwd"),
}


def ate_bound(name):
    a = ATE_JAX[name]
    return max(1.5 * a, a + 0.05)


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


def bound(nbytes, flops):
    """Least time (ms) for the work: bytes over the HBM rate or f32 flops
    over the f32 rate, the larger of the two, and which one it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def counters():
    return {
        "hit_table": raycast.hit_table_launches,
        "hits_field_fwd": render.hits_field_fwd_launches,
        "hits_field_bwd": render.hits_field_bwd_launches,
        "active_field_fwd": render.active_field_fwd_launches,
        "gn_system": tr.gn_system_launches,
        "insert": vm.insert_launches,
    }


def zero_counters():
    raycast.hit_table_launches = 0
    render.hits_field_fwd_launches = render.hits_field_bwd_launches = 0
    render.active_field_fwd_launches = 0
    tr.gn_system_launches = 0
    vm.insert_launches = 0


def record(name, source, replaces, err, k_ms, p_ms, nbytes, flops, library_ms=None):
    b_ms, b_by = bound(nbytes, flops)
    log(f"[{name}] kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
        f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP)"
        + ("" if library_ms is None else f", library {library_ms:.4f} ms"))
    return {"name": name, "route": "cuda", "source": f"nerfloam_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def rows_read(aid, valid):
    """Distinct packed rows the valid samples need (512 B each)."""
    return int(torch.unique(aid[valid]).numel())


def kernel_phase(slam, ds):
    """The six kernels against their plain versions at the quality shapes."""
    dev = slam.device
    cfg, rc_t, rc_m = slam.map_cfg, slam.rc_track, slam.rc_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    frames = []
    for i in range(4):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, ds.get_init_pose(i), slam.points_pad))
    ms = vm.create(cfg, dev)
    ms = vm.recenter(ms, cfg, torch.as_tensor(frames[0].pose6[:3], device=dev))
    for f in frames[:3]:
        p, c, v = f.device_arrays(dev)
        ms = vm.insert_frame(ms, cfg, p, c, v, torch.as_tensor(f.pose6, device=dev),
                             slam.insert_cand_cap)
    emb = (torch.randn(ms.embeddings.shape, generator=gen, device=dev) * 0.1)
    ms = vm.refresh_active(ms._replace(embeddings=emb.to(ms.embeddings.dtype)), cfg)
    log(f"[kernels] map: {int(ms.num_lat)} lattice rows, {int(ms.n_active)} active voxels "
        f"(A={ms.packed.shape[0]}), grid {cfg.grid_dim}, support {cfg.support_dist} m "
        f"sym {cfg.support_sym}")

    p, c, v = frames[0].device_arrays(dev)
    pose = torch.as_tensor(pose6_from_matrix_np(ds.get_init_pose(0)), device=dev)

    def rays(n):
        idx, rvalid = sample_ray_indices(v, n, gen)
        pts, pcos = p[idx], c[idx]
        d = se3.rotate_dirs(pose, _ray_dirs(pts))
        o = se3.pose_translation(pose).expand_as(d).contiguous()
        return o, d.contiguous(), t_cap_for(pts, pcos, 0.3, rc_t.max_depth), pts, pcos, rvalid

    records = []

    # ---- K4 at the tracker (R=2048) and BA superset (R=4096) shapes
    worst_t = worst_cdf = 0.0
    tables = {}
    for R in (slam.tp.n_rays, 2 * slam.bp_current.n_rays):
        o, d, tc, pts, pcos, rvalid = rays(R)
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
        tables[R] = (o, d, tc, ref, pts, pcos, rvalid)
        hits = float((ref.aid >= 0).sum(1).float().mean())
        log(f"[K4] R={R}: mean hits/ray {hits:.2f}, ray hit rate "
            f"{float(ref.ray_mask.float().mean()):.3f}, t/seg err {e_t:.3g}, cdf rel err {e_c:.3g}")
    o, d, tc, ht, *_ = tables[2 * slam.bp_current.n_rays]
    R, H = o.shape[0], rc_t.max_hits
    cstep, S = raycast._coarse_shape(rc_t)
    # probes the rays need: each walks to its range (t_cap + one step)
    probes = float(torch.clamp(torch.ceil((tc + cstep) / cstep), max=S).sum())
    k_ms = median_ms(lambda: raycast.build_hit_table(ms, cfg, rc_t, o, d, tc))
    p_ms = median_ms(lambda: raycast.build_hit_table_plain(ms, cfg, rc_t, o, d, tc))
    log(f"[K4] R={R} S={S} H={H}: {probes / R:.1f} probes per ray")
    records.append(record("hit_table", "hit_table.cu", "nerfloam_tpu/ops/raycast.py:159",
                          max(worst_t, worst_cdf), k_ms, p_ms,
                          R * 28 + 4 * probes + R * H * 28 + R, 12 * probes + 20 * R * H))

    # ---- K1 / K2 at the tracker (M=64) and BA (M=48) shapes, with the
    # origin moved 1 cm off the table's so samples re-resolve
    e1 = e2p = 0.0
    times = {}
    for name, R, M in (("track", slam.tp.n_rays, rc_t.n_samples),
                       ("ba", slam.bp_current.n_rays, rc_m.n_samples)):
        o, d, tc, ht, *_ = tables[slam.tp.n_rays] if name == "track" else tables[2 * R]
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
        nv, nrows = int(valid.sum()), rows_read(aid, valid)
        log(f"[K1/K2] {name} R={R} M={M}: valid {float(valid.float().mean()):.3f}, "
            f"feats err {ef:.3g}, dxyz rel err {ex:.3g}, dpacked err {ep:.3g} "
            f"(max |dpacked| {float(rp.abs().max()):.3g}, rows {kp.shape[0]}, "
            f"distinct rows read {nrows})")
        times[name] = (
            median_ms(lambda: render.hits_field_fwd(ht, u, o, d, ms.packed, cfg.voxel_size)),
            median_ms(lambda: render.hits_field_fwd_plain(ht, u, o, d, ms.packed,
                                                          cfg.voxel_size)),
            median_ms(lambda: render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed,
                                                    cfg.voxel_size)),
            median_ms(lambda: render.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed,
                                                          cfg.voxel_size, True)),
            # fwd: hit table + jitter + rays + rows in, z/valid/aid/xyz/feats out
            R * H * 32 + R * M * 4 + R * 24 + 512 * nrows + R * M * 85, 300 * nv + 40 * R * M,
            # bwd: dfeats/xyz/aid/valid + rows in, d xyz and the dense d packed out
            R * M * 81 + 512 * nrows + R * M * 12 + ms.packed.numel() * 4, 700 * nv,
        )
        log(f"[K1/K2] {name}: fwd kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms;"
            f" bwd kernel {times[name][2]:.4f} ms, plain {times[name][3]:.4f} ms")
    k1, p1, k2, p2, b1, f1, b2, f2 = times["ba"]
    records.append(record("hits_field_fwd", "hits_field.cu", "nerfloam_tpu/core/render.py:108",
                          e1, k1, p1, b1, f1))
    records.append(record("hits_field_bwd", "hits_field.cu", "nerfloam_tpu/core/ba.py:335",
                          e2p, k2, p2, b2, f2))

    # ---- K8: the tracker's band + anchor columns (2048, 8) and the bias
    # probe over one frame's measured points (65536, 1)
    o, d, tc, ht, pts, pcos, rvalid = tables[slam.tp.n_rays]
    R = o.shape[0]
    tp = slam.tp
    ub = torch.rand((R, tp.band_samples), generator=gen, device=dev)
    ez = render.extra_surface_z(torch.linalg.norm(pts, dim=-1), pcos, tp.truncation,
                                tp.surface_anchor, tp.band_samples, ub)
    depth = torch.linalg.norm(p, dim=-1)
    xyz_probe = se3.transform_points(pose, p).reshape(-1, 1, 3)
    pv = v & (depth < rc_m.max_depth)
    e8, k8 = 0.0, {}
    for label, args in (("band", (o, d, ez, rvalid)),
                        ("probe", (None, None, depth.reshape(-1, 1), pv, xyz_probe))):
        ker = render.active_field_fwd(ms, cfg, ms.packed, *args)
        ref = render.active_field_fwd_plain(ms, cfg, ms.packed, *args)
        torch.cuda.synchronize()
        for i, nm in enumerate(("aid", "valid", "xyz")):
            check(torch.equal(ker[i], ref[i]), f"K8 {nm} differs ({label})")
        ef = max_abs(ker[3], ref[3])
        check(ef <= 1e-6, f"K8 feats error {ef} ({label})")
        e8 = max(e8, ef)
        n, nv, nrows = ref[1].numel(), int(ref[1].sum()), rows_read(ref[0], ref[1])
        # rays (or points) + z + ray_valid + one grid cell per sample + rows
        # in; aid/valid/xyz/feats out
        k8[label] = (median_ms(lambda: render.active_field_fwd(ms, cfg, ms.packed, *args)),
                     median_ms(lambda: render.active_field_fwd_plain(ms, cfg, ms.packed, *args)),
                     (R * 24 if label == "band" else n * 12) + n * 8 + ref[1].shape[0]
                     + 512 * nrows + 81 * n, 300 * nv + 20 * n)
        log(f"[K8] {label} {tuple(ref[1].shape)}: valid {nv / n:.3f}, feats err {ef:.3g}, "
            f"distinct rows {nrows}; kernel {k8[label][0]:.4f} ms, plain {k8[label][1]:.4f} ms")
    records.append(record("active_field_fwd", "active_field.cu",
                          "nerfloam_tpu/core/render.py:181", e8, *k8["band"]))

    # ---- K3 on one tracker iteration's real columns (2048, 64 + 8)
    u = raycast.uniform_jitter((R, rc_t.n_samples), gen, dev)
    t_pos = se3.pose_translation(pose)
    z, valid, aid, xyz, feats = render.columns_fwd(ht, u, o, d, ms.packed, cfg.voxel_size,
                                                   (ms, cfg, ez, rvalid))
    sdf, g = tr.field_and_grad(slam.state.decoder_params, feats, xyz, aid, valid, ms.packed,
                               cfg.voxel_size, getattr(torch, tp.compute_dtype))
    vmask = valid & rvalid[:, None]
    d_meas = torch.linalg.norm(pts, dim=-1) * pcos
    depth_ok = (d_meas > 0.0) & (d_meas < tp.max_depth)
    bias_ray = torch.where(pcos < 0.999, 0.01, -0.005)
    a3 = (xyz, t_pos, z, sdf, g, vmask, pcos, d_meas, depth_ok, tp, bias_ray)
    kH, kb, kl = tr.gn_system(*a3)
    kH2, kb2, kl2 = tr.gn_system(*a3)
    rH, rb, rl = tr.gn_system_plain(*a3)
    torch.cuda.synchronize()
    check(torch.equal(kH, kH2) and torch.equal(kb, kb2) and torch.equal(kl, kl2),
          "K3 differs between two runs")
    e3 = 0.0
    for nm, k, r in (("H", kH, rH), ("b", kb, rb), ("loss", kl, rl)):
        rel = max_abs(k, r) / max(float(r.abs().max()), 1e-30)
        check(rel <= 1e-4, f"K3 {nm} rel error {rel}")
        e3 = max(e3, max_abs(k, r))
        log(f"[K3] {nm}: rel err {rel:.3g} (max |{nm}| {float(r.abs().max()):.4g})")
    # the library comparison: the einsum pair of the twin, on J, w, r
    # precomputed as the twin computes them
    T = tp.truncation
    zc = z * pcos[:, None]
    front = (zc < (d_meas[:, None] - T)) & vmask
    band = vmask & ~front & ~(zc > (d_meas[:, None] + T)) & depth_ok[:, None]
    tot = torch.clamp(front.sum() + band.sum(), min=1).float()
    w = torch.where(front, tp.fs_weight * (1.0 - front.sum() / tot),
                    tp.sdf_weight * (1.0 - band.sum() / tot)) * (front | band)
    r = torch.where(front, sdf - 1.0, (zc + (sdf - bias_ray[:, None]) * T) - d_meas[:, None])
    gj = g * torch.where(front, 1.0, T)[..., None]
    J = torch.cat([gj, torch.linalg.cross(xyz - t_pos, gj, dim=-1)], -1)
    Jw = J * w[..., None]
    lib_ms = median_ms(lambda: (torch.einsum("nmi,nmj->ij", Jw, J),
                                torch.einsum("nmi,nm->i", Jw, r)))
    k_ms = median_ms(lambda: tr.gn_system(*a3))
    p_ms = median_ms(lambda: tr.gn_system_plain(*a3))
    n, nv = z.numel(), int(vmask.sum())
    log(f"[K3] {tuple(z.shape)}: {nv} valid samples, front {int(front.sum())}, "
        f"band {int(band.sum())}")
    # xyz/z/sdf/g/mask per sample, pcos/d/bias/ok per ray in; H, b, loss out
    records.append(record("gn_system", "gn_system.cu", "nerfloam_tpu/core/tracking.py:217",
                          e3, k_ms, p_ms, 33 * n + 13 * R + 12 + 172, 100 * nv, lib_ms))

    # ---- K7: one frame with symmetric support (3 x 65536 points),
    # appending to the active set
    f = frames[3]
    p3, c3, v3 = f.device_arrays(dev)
    p6 = torch.as_tensor(f.pose6, device=dev)
    world = se3.transform_points(p6, p3)
    dirs = p3 / (torch.linalg.norm(p3, dim=-1, keepdim=True) + 1e-8)
    off = torch.where(c3[:, None] < 0.999, torch.tensor([0.0, 0.0, -1.0], device=dev),
                      se3.rotate_dirs(p6, dirs))
    pts7 = torch.cat([world, world + off * cfg.support_dist, world - off * cfg.support_dist])
    val7 = torch.cat([v3] * 3)
    args7 = (ms, cfg, pts7, val7, slam.insert_cand_cap, True)
    ker = vm.insert_points(*args7)
    ref = vm.insert_points_plain(*args7)
    torch.cuda.synchronize()
    for nm in vm.MapState._fields:
        check(torch.equal(getattr(ker, nm), getattr(ref, nm)), f"K7 {nm} differs")
    n_new = int(ref.num_lat) - int(ms.num_lat)
    n_act = int(ref.n_active) - int(ms.n_active)
    n_cand = int(ref.num_cand)
    Pc = min(n_cand, slam.insert_cand_cap)
    log(f"[K7] {pts7.shape[0]} points: {n_cand} candidates, {n_new} new rows, {n_act} activated "
        f"(n_active {int(ref.n_active)}); every table equal")
    k_ms = median_ms(lambda: vm.insert_points(*args7))
    p_ms = median_ms(lambda: vm.insert_points_plain(*args7))
    P = pts7.shape[0]
    # in place at the least: points + their cell (grid, is_surface) in, 8
    # corner cells per candidate, the new rows (coords + grid), the
    # activated voxels (is_surface, corner_idx) and their appended entries
    # (ids, coords, grid_active, packed row) out
    records.append(record("insert", "insert.cu", "nerfloam_tpu/map/voxel_map.py:311", 0.0,
                          k_ms, p_ms, P * 18 + 32 * Pc + 16 * n_new + n_act * (33 + 532),
                          10 * P))
    return records


def main_path(name, slam, ds):
    """30 frames of one config through NerfLoamSLAM_torch."""
    frames = []
    for i in range(len(ds)):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    for f in frames:
        f.device_arrays(slam.device)

    zero_counters()
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
    launches = counters()
    n_timed = len(frames) - WARMUP_FRAMES
    scans = n_timed / dt
    gt = ds.gt_trajectory()[: len(poses)]
    ate = float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))))
    tag = f"[main {name}]"
    log(f"{tag} {len(frames)} frames in {total:.2f} s (finalize included); "
        f"scans/s over frames {WARMUP_FRAMES}-{len(frames) - 1}: {scans:.4f}")
    log(f"{tag} launches: {launches}; per frame ({len(frames)} frames + finalize): "
        + ", ".join(f"{k} {v / len(frames):.2f}" for k, v in launches.items()))
    log(f"{tag} overflow events {slam.overflow_events}, dropped {slam.dropped_delta_events}, "
        f"host syncs {slam.host_syncs} ({slam.host_syncs / len(frames):.2f} per frame)")
    log(f"{tag} sections (ms): " + json.dumps(
        {k: round(v["mean_ms"], 3) for k, v in slam.prof.summary().items()}))
    ms = slam.state.map_state
    log(f"{tag} final sdf_bias {slam.sdf_bias.tolist()}, num_lat {int(ms.num_lat)}, "
        f"n_active {int(ms.n_active)}, keyframes {len(slam.state.keyframes)}")
    log(f"{tag} ATE {ate:.4f} m (bound {ate_bound(name):.4f} m from JAX {ATE_JAX[name]:.4f} m); "
        f"final position {poses[-1][:3, 3].tolist()}, GT {gt[-1][:3, 3].tolist()}")
    check(len(poses) == len(frames), f"{len(poses)} poses for {len(frames)} frames")
    check(np.isfinite(poses).all(), "non-finite pose")
    check(bool(torch.isfinite(ms.embeddings.float()).all()), "non-finite embeddings")
    check(all(bool(torch.isfinite(w).all()) for w in slam.state.decoder_params["w"]),
          "non-finite decoder")
    check(np.isfinite(slam.sdf_bias).all(), "non-finite sdf_bias")
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, f"kernel {k} never launched on the {name} path")
    check(ate <= ate_bound(name), f"ATE {ate} above bound {ate_bound(name)} ({name})")
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
    # the port's own kernels (csrc/*.cu): device time per launch on the path
    ours = [e for e in events if e.key.startswith("(anonymous namespace)::")]
    for e in sorted(ours, key=dev, reverse=True):
        log(f"[profile] port kernel {e.key.split('::')[1].split('(')[0]}: "
            f"{dev(e) / n_profiled:.4f} ms/frame, {e.count / n_profiled:.1f} launches/frame, "
            f"{dev(e) / e.count * 1e3:.2f} us/launch (device)")


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
    log(f"[build] {len(kernels.build_info.get('built', []))} sources built in parallel and "
        f"loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc wall {kernels.build_info.get('seconds', 0.0):.2f} s)")
    for src, out in kernels.build_info.get("log", {}).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    cfgs = {n: load_json_config(os.path.join(here, "nerfloam_tpu_torch", "configs", f"{n}.json"))
            for n in ("kitti_budget", "kitti_quality")}
    ds = get_dataset(cfgs["kitti_quality"])  # both configs share the data specs
    records = kernel_phase(NerfLoamSLAM_torch(cfgs["kitti_quality"], ds, device="cuda"), ds)
    results = {}
    for n in ("kitti_budget", "kitti_quality"):
        results[n] = main_path(n, NerfLoamSLAM_torch(cfgs[n], ds, device="cuda"), ds)
        torch.cuda.empty_cache()
    profile_phase(cfgs["kitti_quality"], ds)
    for r in records:
        r["launches"] = results["kitti_quality"][0][r["name"]]
        r["launches_by_path"] = {n: results[n][0][r["name"]] for n in results}
    log(f"[result] scans/s budget {results['kitti_budget'][1]:.4f}, quality "
        f"{results['kitti_quality'][1]:.4f} on {smi}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
