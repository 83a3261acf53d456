#!/usr/bin/env python3
"""Device launches, device us and wrapper ms of the GN iteration's tail and
of a pose's rotation of its rays, forward and backward, on one CUDA card,
at the main path's shapes:

- the GN tail at the tracker's 2048 rays: the damping, the solve, the pose
  step and the next iteration's rotation of the ray directions;
- the rotation of BA's rays (the current frame, W = 1, and the window,
  W = 4, of 2048 rays each: origins and directions, then the pose's
  gradient from their cotangents) and of the Adam tracker's 2048 rays.

Each is profiled in the chain of eager operations the port ran before
``tracking.lm_tail`` and ``se3.pose_rays`` (chip_smoke.parent_gn_tail,
chip_smoke.parent_pose_rays) and through those two kernels; the chains and
the kernels are timed in turns (CUDA events), and their host us taken
with the card idle before each call.

    python3 scripts/tail_rotation_profile.py

Prints no result line.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def device_us_all(fn, reps=20):
    """Device us a call of every device operation fn launches (the port's
    kernels, torch's, cuSOLVER's and cuBLAS's, copies and fills), from one
    torch.profiler session of ``reps`` calls after a discarded warm-up step;
    and {operation: launches a call}."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(cs.PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(cs.PROFILE_PAD_S)
            prof.step()
    events = [e for e in prof.key_averages() if cs._on_device(e)]
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / reps
    return total, {e.key[:60]: e.count / reps for e in events}


def main():
    if not torch.cuda.is_available():
        print("tail_rotation_profile: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"[device] {smi}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, (chain, kernel, want) in cs.tail_rotation_cases(gen).items():
        for form, fn, fns in (("parent chain", chain, want[0]), ("kernel", kernel, want[1])):
            per_fn, per_call, launches = cs.device_us(label, fn, want=fns)
            total, ops = device_us_all(fn)
            cs.log(f"[{label}] {form}: {launches:g} device launches a call, {total:.2f} device "
                   f"us a call in all, {per_call:.2f} of them the port's kernels ("
                   + ", ".join(f"{k} {v:.2f}" for k, v in per_fn.items()) + ")")
            cs.log(f"[{label}] {form}: launches a call by operation {ops}")
        k_ms, c_ms = cs.paired_median_ms(kernel, chain)
        cs.log(f"[{label}] wrapper ms in turns: kernel {k_ms:.4f}, parent chain {c_ms:.4f}; "
               f"host us, card idle before each: kernel {cs.host_us_idle(kernel):.2f}, "
               f"parent chain {cs.host_us_idle(chain):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
