"""Section timing with CUDA events (port of nerfloam_tpu/utils/profiler.py,
which imports jax). On a CUDA device each section records an event pair on
the current stream and is resolved in ``summary()``, so timing adds no
host synchronisation inside the frame; on the CPU it uses the host clock."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Profiler:
    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self._pending = defaultdict(list)   # name -> [(start, end) events]
        self.log = defaultdict(list)        # name -> [ms]

    @contextlib.contextmanager
    def section(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending[name].append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.log[name].append((time.perf_counter() - t0) * 1000.0)

    def summary(self) -> dict:
        if self._pending:
            torch.cuda.synchronize()
            for name, pairs in self._pending.items():
                self.log[name].extend(s.elapsed_time(e) for s, e in pairs)
            self._pending.clear()
        return {k: {"count": len(v), "mean_ms": sum(v) / max(len(v), 1), "total_ms": sum(v)}
                for k, v in self.log.items()}
