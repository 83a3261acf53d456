#!/usr/bin/env python3
"""Device and host time of K7 (voxel insert) and K11a (range image) at the
shapes the main paths give them, on one CUDA card, through the functions
every tree of the port has since its fourth slice
(``voxel_map.insert_points`` and ``scan2scan.build_prev_scan``), with
every device operation of a call listed by name: the port's kernels and
the torch operations of the wrapper (clones, fills, prefix sums, the
rotation), each with its launches and device us per call.

    python3 scripts/k7_k11a_profile.py

Run it from the root of the tree to profile (it imports that tree's
package and its chip_smoke.py for the profiler helpers and the CUDA
function names); to compare two trees in one call, copy it into the
other tree's ``scripts/`` and run the two in turns.

Shapes: K7 as chip_smoke.py's kernel phase calls it, the quality
config's fourth frame with symmetric support (196,608 points) inserted
with the run's candidate cap and the active-set append into the map of
its first three frames; where ``insert_points`` works in place (a tree
with ``voxel_map.undo_insert``), each call is followed by the undo of its
record, listed apart, and the insert keeps one ``InsertScratch``. K11a at
one frame's 65,536 points into the s2s config's 64 x 1024 image, and
``se3.pose_rotation`` alone (the rotation the wrapper builds). Prints no
result line.
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
from nerfloam_tpu_torch.core import scan2scan as s2s  # noqa: E402
from nerfloam_tpu_torch.core.frame import Frame  # noqa: E402
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.map import voxel_map as vm  # noqa: E402
from nerfloam_tpu_torch.ops import se3  # noqa: E402

log = cs.log
IN_PLACE = hasattr(vm, "undo_insert")


def op_split(label, fn, reps=20, sessions=5):
    """Every device operation of one call of fn: (name, launches per call,
    device us per call), from torch.profiler over ``reps`` calls after a
    discarded warm-up step; a session whose recurring operations are not a
    whole multiple of ``reps`` (dropped or stray records) is run again."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     acc_events=True) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ops = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
               for e in prof.key_averages() if cs._on_device(e) and e.count >= reps]
        if not any(n % reps for _, n, _ in ops):
            break
    else:
        raise AssertionError(f"{label}: the profiler dropped or added records")
    ops.sort(key=lambda o: -o[2])
    total_n, total_us = sum(n for _, n, _ in ops) / reps, sum(t for _, _, t in ops) / reps
    log(f"[split {label}] {total_n:g} device launches, {total_us:.2f} us per call:")
    for key, n, t in ops:
        log(f"[split {label}]   {n / reps:5g} x {t / n:8.2f} us = {t / reps:8.2f} us  {key[:110]}")
    return ops


def host(label, pieces):
    log(f"[host {label}] us per call (card idle before each): "
        + ", ".join(f"{k} {cs.host_us_idle(fn):.2f}" for k, fn in pieces.items()))


def build_map(slam, ds, dev, gen, n_frames=3):
    """The first frames inserted around frame 0, random embeddings, the
    active set refreshed; (map, frames)."""
    cfg = slam.map_cfg
    frames = []
    for i in range(n_frames + 1):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, ds.get_init_pose(i), slam.points_pad))
    ms = vm.create(cfg, dev)
    ms = vm.recenter(ms, cfg, torch.as_tensor(frames[0].pose6[:3], device=dev))
    for f in frames[:n_frames]:
        p, c, v = f.device_arrays(dev)
        out = vm.insert_frame(ms, cfg, p, c, v, torch.as_tensor(f.pose6, device=dev),
                              slam.insert_cand_cap)
        ms = out[0] if IN_PLACE else out
    emb = torch.randn(ms.embeddings.shape, generator=gen, device=dev) * 0.1
    return vm.refresh_active(ms._replace(embeddings=emb.to(ms.embeddings.dtype)), cfg), frames


def k7_points(cfg, frame, dev):
    """A frame's points with symmetric support, as insert_frame forms them."""
    p3, c3, v3 = frame.device_arrays(dev)
    p6 = torch.as_tensor(frame.pose6, device=dev)
    world = se3.transform_points(p6, p3)
    dirs = p3 / (torch.linalg.norm(p3, dim=-1, keepdim=True) + 1e-8)
    off = torch.where(c3[:, None] < 0.999, torch.tensor([0.0, 0.0, -1.0], device=dev),
                      se3.rotate_dirs(p6, dirs))
    pts = torch.cat([world, world + off * cfg.support_dist, world - off * cfg.support_dist])
    return pts.contiguous(), torch.cat([v3] * 3)


def k7(slam, ms, frame):
    dev, cfg = slam.device, slam.map_cfg
    pts, val = k7_points(cfg, frame, dev)
    log(f"[K7] {pts.shape[0]} points into {int(ms.num_lat)} rows, {int(ms.n_active)} active; "
        f"cand_cap {slam.insert_cand_cap}, append_active; in place: {IN_PLACE}")
    if IN_PLACE:
        scratch = vm.InsertScratch()
        ins = partial(vm.insert_points, ms, cfg, pts, val, slam.insert_cand_cap, True,
                      scratch=scratch)

        def call():
            vm.undo_insert(*ins())

        op_split("K7 insert_points + undo_insert", call)
        _, rec = ins()
        host("K7", {"insert_points, scratch kept": lambda: vm.undo_insert(*ins()),
                    "undo_insert": partial(vm.undo_insert, ms, rec)})
        vm.undo_insert(ms, rec)
    else:
        call = partial(vm.insert_points, ms, cfg, pts, val, slam.insert_cand_cap, True)
        op_split("K7 insert_points", call)
        host("K7", {"insert_points": call})


def k11a(sp, frame, dev):
    p0, _, v0 = frame.device_arrays(dev)
    pose0 = torch.as_tensor(frame.pose6, device=dev)
    call = partial(s2s.build_prev_scan, sp, p0, v0, pose0)
    log(f"[K11a] {p0.shape[0]} points into {sp.n_elev} x {sp.n_az}")
    op_split("K11a build_prev_scan", call)
    op_split("K11a's rotation, se3.pose_rotation alone", partial(se3.pose_rotation, pose0))
    host("K11a", {"build_prev_scan": call,
                  "se3.pose_rotation": partial(se3.pose_rotation, pose0)})


def main():
    if not torch.cuda.is_available():
        print("k7_k11a_profile: needs a CUDA card", file=sys.stderr)
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
    k7(q, ms, frames[3])
    sp = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "kitti_quality_s2s"), None, device=dev).tp.s2s
    k11a(sp, frames[0], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
