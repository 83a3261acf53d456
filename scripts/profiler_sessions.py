#!/usr/bin/env python3
"""How often torch.profiler loses a session's device records on one CUDA
card, and where the records it keeps sit against the launches that made
them. Runs rounds of short profiler sessions of ``--reps`` calls of a small
elementwise kernel for ``--seconds``, in three forms:

- ``schedule``: a warm-up step discarded, then an active step, as
  chip_smoke.py's ``device_us`` profiled before;
- ``padded``: the same, with ``--pad-ms`` of host sleep inside the active
  step before the first call and after the last;
- ``plain``: one profile() context around the calls, no schedule.

For each round it prints the sessions that kept fewer or more than
``--reps`` kernel records, and, in the plain form, the spread of the first
kernel record's start less the first launch call's start (us), which
shows whether the device clock drifts from the host's in the trace.

    python3 scripts/profiler_sessions.py [--seconds 240] [--sessions 40]

Prints no result line.
"""

import argparse
import json
import os
import time

import torch


def kernel_records(prof, reps):
    n, dev_start, launch_start = 0, [], []
    for e in prof.events():
        on_dev = getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
        if on_dev and "elementwise" in e.name.lower():
            n += 1
            dev_start.append(e.time_range.start)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launch_start.append(e.time_range.start)
    lag = (min(dev_start) - min(launch_start)) if dev_start and launch_start else None
    return n, lag


def session(form, step, reps, pad_s):
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if form == "plain":
        with profile(activities=acts) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        return kernel_records(prof, reps)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        for active in (False, True):
            if active and form == "padded":
                time.sleep(pad_s)
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
            if active and form == "padded":
                time.sleep(pad_s)
            prof.step()
    return kernel_records(prof, reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--sessions", type=int, default=40, help="sessions of each form a round")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    args = ap.parse_args()
    x = torch.ones(1 << 20, device="cuda")

    def step():
        x.mul_(1.0000001)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals = {f: [0, 0] for f in ("schedule", "padded", "plain")}
    rnd = 0
    while time.perf_counter() - t0 < args.seconds:
        row = {"round": rnd, "t_s": round(time.perf_counter() - t0, 1)}
        for form in totals:
            bad, lags = [], []
            for _ in range(args.sessions):
                n, lag = session(form, step, args.reps, args.pad_ms / 1e3)
                if n != args.reps:
                    bad.append(n)
                if lag is not None:
                    lags.append(lag)
            totals[form][0] += args.sessions
            totals[form][1] += len(bad)
            row[form] = {"off": bad}
            if lags:
                lags.sort()
                row[form]["lag_us"] = [round(lags[0], 1), round(lags[len(lags) // 2], 1),
                                       round(lags[-1], 1)]
        print(json.dumps(row), flush=True)
        rnd += 1
    print(json.dumps({"sessions_and_off": totals, "torch": torch.__version__,
                      "pid": os.getpid()}), flush=True)


if __name__ == "__main__":
    main()
