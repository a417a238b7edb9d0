"""Tracing and stage timing.

Port of `endodav_tpu/utils/profiling.py`: `trace(log_dir)` records a
`torch.profiler` trace of the region (CPU and, where there is one, CUDA
activity) into ``log_dir`` as a Chrome trace (a no-op for None), and
`StageTimer` accumulates wall-clock time by stage, waiting for the card
(`torch.cuda.synchronize`) at both ends of a stage where there is one, as
JAX blocks on a zero array, so that queued work is charged to its stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["trace", "StageTimer"]


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Write a `torch.profiler` Chrome trace of the region into ``log_dir``
    (no-op if None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulating per-stage timer; with ``sync`` (and a card) each stage
    waits for the card's queued work before and after."""

    def __init__(self, sync: bool = True):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync and torch.cuda.is_available()

    def _wait(self):
        if self.sync:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        self._wait()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._wait()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            mean_ms = self.totals[name] / max(self.counts[name], 1) * 1000
            lines.append(f"{name}: total {self.totals[name]:.2f}s | mean {mean_ms:.1f}ms "
                         f"x{self.counts[name]}")
        return "\n".join(lines)
