#!/usr/bin/env python3
"""Device and host time of K4 (hit table), K5 (reconcile + repack) and K6
(recenter + active set, for its pack pass) at the shapes the main paths
give them, on one CUDA card, through the functions every tree of the
port has since its third slice (``raycast.build_hit_table``,
``raycast.pack_hit_table``, ``voxel_map.reconcile``, ``recenter`` and
``refresh_active``) and, where the tree has them, BA's packed hit table
(``raycast.build_hit_table_packed``) and K5's kept scratch
(``voxel_map.ReconcileScratch``).

    python3 scripts/k4_k5_profile.py

Run it from the root of the tree to profile (it imports that tree's
package and its chip_smoke.py for the profiler helpers and the CUDA
function names); to compare two trees in one call, copy it into the
other tree's ``scripts/`` and run the two in turns.

Shapes: the kernel phase's map of chip_smoke.py (the quality config's
first three frames inserted, random embeddings): K4 at the tracker's
2048 rays and at BA's 4096-ray superset, each with one origin per ray
and with one origin expanded to every ray (row stride 0, as the tracker
and a one-frame BA step pass it), and BA's form (the superset's table
packed into (R, 7H) rows); K5 at the quality shape (bf16 embeddings,
A = 131,072, C = 2,097,152, T = 32,768, about 60% of T touched) and at
the replica gate's (f32, A = 49,152, C = 262,144, its current-frame
T, on a map of the gate's first frames); K6 one frame's move on the
quality map. For each it prints device us per launch of each CUDA
function and CUDA launches per call (torch.profiler), and host us per
call. Prints no result line.
"""

import os
import subprocess
import sys
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerfloam_tpu_torch import kernels  # noqa: E402
from nerfloam_tpu_torch.core import tracking as tr  # noqa: E402
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np  # noqa: E402
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.map import voxel_map as vm  # noqa: E402
from nerfloam_tpu_torch.ops import raycast, se3  # noqa: E402
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices  # noqa: E402

log = cs.log


def profile(label, name, fn):
    """chip_smoke's per-function device us and launches of one call."""
    per_fn, per_call, launches = cs.device_us(name, fn)
    log(f"[profile {label}] device us per launch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_fn.items())
        + f"; {per_call:.2f} us per call; {launches:g} CUDA launches per call")
    return per_fn


def host(label, pieces):
    log(f"[host {label}] us per call: "
        + ", ".join(f"{k} {cs.host_us(fn):.2f}" for k, fn in pieces.items()))


def build_map(slam, ds, dev, gen, n_frames=3):
    """The first frames inserted around frame 0, random embeddings, the
    active set refreshed; (map, frames)."""
    cfg = slam.map_cfg
    frames = []
    for i in range(n_frames):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, ds.get_init_pose(i), slam.points_pad))
    ms = vm.create(cfg, dev)
    ms = vm.recenter(ms, cfg, torch.as_tensor(frames[0].pose6[:3], device=dev))
    for f in frames:
        p, c, v = f.device_arrays(dev)
        ms = vm.insert_frame(ms, cfg, p, c, v, torch.as_tensor(f.pose6, device=dev),
                             slam.insert_cand_cap)
    emb = torch.randn(ms.embeddings.shape, generator=gen, device=dev) * 0.1
    return vm.refresh_active(ms._replace(embeddings=emb.to(ms.embeddings.dtype)), cfg), frames


def k4(slam, ms, frame, ds, gen):
    dev, cfg, rc = slam.device, slam.map_cfg, slam.rc_track
    p, c, v = frame.device_arrays(dev)
    pose = torch.as_tensor(pose6_from_matrix_np(ds.get_init_pose(0)), device=dev)
    has_packed = hasattr(raycast, "build_hit_table_packed")
    for R in (slam.tp.n_rays, 2 * slam.bp_current.n_rays):
        idx, _ = sample_ray_indices(v, R, gen)
        d = se3.rotate_dirs(pose, tr._ray_dirs(p[idx])).contiguous()
        o1 = se3.pose_translation(pose).expand_as(d)
        tc = tr.t_cap_for(p[idx], c[idx], slam.tp.truncation, slam.tp.max_depth)
        forms = {"origin per ray": o1.contiguous(), "origin row stride 0": o1}
        for form, o in forms.items():
            call = partial(raycast.build_hit_table, ms, cfg, rc, o, d, tc)
            profile(f"K4 R={R}, {form}", "hit_table", call)
            host(f"K4 R={R}, {form}", {"build_hit_table": call})
        if R == 2 * slam.bp_current.n_rays:  # BA's form: the superset's table packed
            ba = (partial(raycast.build_hit_table_packed, ms, cfg, rc, o1, d, tc) if has_packed
                  else lambda: raycast.pack_hit_table(raycast.build_hit_table(ms, cfg, rc, o1, d,
                                                                              tc)))
            name = "build_hit_table_packed" if has_packed else "pack_hit_table(build_hit_table)"
            profile(f"K4 R={R}, BA's packed table ({name}), origin row stride 0", "hit_table", ba)
            host(f"K4 R={R}, BA's packed table, origin row stride 0", {name: ba})


def touched_set(ms, T, gen):
    """About 60% of the cap touched among the active rows (chip_smoke's K5
    phase), and 0.01-sized deltas on every packed row."""
    dev = ms.packed.device
    A, n_act = ms.packed.shape[0], min(int(ms.n_active), ms.packed.shape[0])
    pick = torch.rand((A,), generator=gen, device=dev) < min(1.0, 0.6 * T / max(n_act, 1))
    touched = pick & (torch.arange(A, device=dev) < n_act)
    new_packed = ms.packed + 0.01 * torch.randn(ms.packed.shape, generator=gen, device=dev)
    return touched, new_packed


def k5(label, slam, ms, gen):
    cfg, T = slam.map_cfg, slam.bp_current.touched_cap
    touched, new_packed = touched_set(ms, T, gen)
    log(f"[K5 {label}] A={ms.packed.shape[0]}, C={cfg.capacity}, T={T}, {ms.embeddings.dtype}, "
        f"{int(ms.n_active)} active, {int(touched.sum())} touched")
    calls = {"reconcile": partial(vm.reconcile, ms, cfg, new_packed, touched, T)}
    if hasattr(vm, "ReconcileScratch"):
        calls["reconcile, scratch kept"] = partial(vm.reconcile, ms, cfg, new_packed, touched, T,
                                                   scratch=vm.ReconcileScratch())
    for form, call in calls.items():
        per_fn = profile(f"K5 {label}, {form}", "reconcile", call)
        pack = sum(v for k, v in per_fn.items() if "pack" in k)
        log(f"[profile K5 {label}, {form}] the pack pass: {pack:.2f} of "
            f"{sum(per_fn.values()):.2f} us ({pack / max(sum(per_fn.values()), 1e-9):.3f})")
    host(f"K5 {label}", calls)


def k6(slam, ms, frames):
    dev, cfg = slam.device, slam.map_cfg
    center = torch.as_tensor(frames[1].pose6[:3], device=dev)
    kr = vm.recenter(ms, cfg, center)
    per_fn = profile("K6 quality, recenter + refresh_active", "active_set",
                     lambda: vm.refresh_active(vm.recenter(ms, cfg, center), cfg))
    pack = sum(v for k, v in per_fn.items() if "pack" in k)
    log(f"[profile K6 quality] the pack pass: {pack:.2f} of {sum(per_fn.values()):.2f} us "
        f"({pack / max(sum(per_fn.values()), 1e-9):.3f})")
    host("K6 quality", {"recenter": partial(vm.recenter, ms, cfg, center),
                        "refresh_active": partial(vm.refresh_active, kr, cfg)})


def main():
    if not torch.cuda.is_available():
        print("k4_k5_profile: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    q = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "kitti_quality"), None, device=dev)
    ds = get_dataset(q.cfg)
    ms, frames = build_map(q, ds, dev, gen)
    log(f"[map quality] {int(ms.num_lat)} lattice rows, {int(ms.n_active)} active voxels "
        f"(A={ms.packed.shape[0]})")
    k4(q, ms, frames[0], ds, gen)
    k5("quality", q, ms, gen)
    k6(q, ms, frames)
    del ms, frames
    torch.cuda.empty_cache()
    gate = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "replica_gate60", seed=0), None, device=dev)
    gms, _ = build_map(gate, get_dataset(gate.cfg), dev, gen, n_frames=8)
    log(f"[map gate] {int(gms.num_lat)} lattice rows, {int(gms.n_active)} active voxels "
        f"(A={gms.packed.shape[0]})")
    k5("gate", gate, gms, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
