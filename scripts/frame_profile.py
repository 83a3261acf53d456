#!/usr/bin/env python3
"""Device operations of a few steady frames of the port's configs, on one
CUDA card: for each config, torch.profiler over ``--frames`` frames after
the warm-up ones, and every device operation with the most device time by
name, its launches and ms a frame, beside the totals (device launches and
device ms a frame, as chip_smoke.py's ``[profile <cell>]`` lines give
them).

    python3 scripts/frame_profile.py kitti_quality,kitti_budget [--top 40]

It imports the tree it runs in (its package and chip_smoke.py): to
compare two trees in one call, copy it into the other tree's
``scripts/`` and run the two in turns. Prints no result line.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np  # noqa: E402
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402

WARMUP, FRAMES = 5, 3


def profile(name, top):
    from torch.profiler import ProfilerActivity, profile

    cfg = cs.load_cfg(ROOT, name, seed=0 if name == "replica_gate60" else None)
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    frames = []
    for i in range(WARMUP + FRAMES):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    slam.process_first_frame(frames[0])
    for f in frames[1:WARMUP]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(cs.PROFILE_PAD_S)  # the device clock strays: keep the records in the window
        for f in frames[WARMUP:]:
            slam.process_frame(f)
        torch.cuda.synchronize()
        time.sleep(cs.PROFILE_PAD_S)
    events = [e for e in prof.key_averages() if cs._on_device(e)]
    ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3 / FRAMES  # noqa: E731
    tag = f"[frame {name}]"
    cs.log(f"{tag} {sum(e.count for e in events) / FRAMES:.1f} device launches, "
           f"{sum(map(ms, events)):.2f} device ms a frame ({FRAMES} frames after {WARMUP})")
    for e in sorted(events, key=ms, reverse=True)[:top]:
        cs.log(f"{tag} {ms(e):9.3f} ms {e.count / FRAMES:8.1f} x  {e.key[:120]}")
    del slam
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("frame_profile: needs a CUDA card", file=sys.stderr)
        return 1
    top = int(sys.argv[sys.argv.index("--top") + 1]) if "--top" in sys.argv else 40
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"[device] {smi}")
    for name in sys.argv[1].split(","):
        profile(name, top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
