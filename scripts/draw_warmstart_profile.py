#!/usr/bin/env python3
"""Device launches, device us and wrapper ms of a ray draw and of the
deferred warm start on one CUDA card, at the main path's shapes:

- a tracker's draw of 2048 rays over a frame's 65,536 points (the GN
  tracker's frame, the Adam tracker's ``rays_at``): the Gumbel keys, top-k,
  the gathers, the ray setup and the band target;
- BA's superset (4096 rays of each frame, the current frame and a window
  of 4), a BA iteration's pick of 2048 rays a frame from it, and BA's
  fresh draw without a superset (the exact path);
- the deferred warm start (``_const_vel``: two pose matrices, the
  products, the inverse, log_so3).

Each is profiled in the chain of eager operations the port ran before
``tracking.ray_draw`` / ``ray_superset`` / ``ray_pick``,
``sampling.draw_keys`` and ``se3.const_vel`` (chip_smoke.parent_*), and
through those kernels; the chains and the kernels are timed in turns (CUDA
events), and their host us taken with the card idle before each call.

    python3 scripts/draw_warmstart_profile.py [--chains]

``--chains`` profiles the chains alone (a tree without the kernels).
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


def device_ops(fn, reps=20):
    """Device us a call of every device operation fn launches (the port's
    kernels, torch's, cuBLAS's, copies and fills), from one torch.profiler
    session of ``reps`` calls after a discarded warm-up step; its device
    launches a call; and {operation (its name's first 60 characters):
    launches a call}."""
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
    ops = {}
    for e in events:
        ops[e.key[:60]] = ops.get(e.key[:60], 0.0) + e.count / reps
    return total, sum(e.count for e in events) / reps, ops


def main():
    if not torch.cuda.is_available():
        print("draw_warmstart_profile: needs a CUDA card", file=sys.stderr)
        return 1
    chains_only = "--chains" in sys.argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"[device] {smi}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, (chain, kernel, want) in cs.draw_warmstart_cases(gen, chains_only).items():
        forms = (("parent chain", chain, want[0]),) + (
            () if kernel is None else (("kernel", kernel, want[1]),))
        for form, fn, fns in forms:
            total, launches, ops = device_ops(fn)
            port = ""
            if fns:
                per_fn, per_call, _ = cs.device_us(label, fn, want=fns)
                port = (f", {per_call:.2f} of them the port's kernels ("
                        + ", ".join(f"{k} {v:.2f}" for k, v in per_fn.items()) + ")")
            cs.log(f"[{label}] {form}: {launches:g} device launches a call, {total:.2f} device "
                   f"us a call in all{port}")
            cs.log(f"[{label}] {form}: launches a call by operation {ops}")
        if kernel is None:
            cs.log(f"[{label}] wrapper ms: parent chain {cs.median_ms(chain):.4f}; host us, card "
                   f"idle before each: {cs.host_us_idle(chain):.2f}")
            continue
        k_ms, c_ms = cs.paired_median_ms(kernel, chain)
        cs.log(f"[{label}] wrapper ms in turns: kernel {k_ms:.4f}, parent chain {c_ms:.4f}; "
               f"host us, card idle before each: kernel {cs.host_us_idle(kernel):.2f}, "
               f"parent chain {cs.host_us_idle(chain):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
