"""Profiling / tracing hooks.

The reference has no profiling surface at all (the offline progress bar is
its only throughput signal).  This module provides per-stage wall timers
that wait for the device before a stage's clock stops, and a context
manager around ``torch.profiler`` for device traces viewable in Perfetto
or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def sync(tree):
    """Wait until the device has finished the work that made ``tree`` (a
    tensor or a nested tuple/list/dict of them): ``torch.cuda.synchronize``
    on the device of its first CUDA tensor; a no-op for CPU tensors."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                break
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
    return tree


class StageTimer:
    """Accumulates wall time per named stage; device-synced on exit."""

    def __init__(self, device_sync: bool = True):
        self.device_sync = device_sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block; put its device result in the yielded dict under
        ``"result"`` to wait for it before the clock stops."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if self.device_sync and holder.get("result") is not None:
                sync(holder["result"])
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": round(t, 4),
                       "count": self.counts[name],
                       "mean_ms": round(t / max(self.counts[name], 1) * 1e3, 3)}
                for name, t in sorted(self.totals.items(),
                                      key=lambda kv: -kv[1])}

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>8}{'mean ms':>12}{'total s':>10}"]
        for name, s in self.summary().items():
            lines.append(f"{name:<24}{s['count']:>8}{s['mean_ms']:>12.3f}"
                         f"{s['total_s']:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(path: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present); writes a Chrome trace to ``path`` and yields the profiler,
    whose ``key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
