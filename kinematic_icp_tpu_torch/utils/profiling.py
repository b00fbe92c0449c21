"""Profiling / tracing hooks.

The reference has no profiling surface at all (the offline progress bar is
its only throughput signal).  This module provides per-stage wall timers
that wait for the device before a stage's clock stops, and a context
manager around ``torch.profiler`` for device traces viewable in Perfetto
or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import Counter, defaultdict

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


#: CUDA API calls that put work on the device: kernel launches (the GN
#: kernel's cooperative one among them), graph launches, copies and fills
_SUBMITS = re.compile(r"^cu(da)?(Launch|GraphLaunch|Memcpy|Memset)")
#: CUDA API calls that make the host wait for the device
_SYNCS = re.compile(r"^cu(da)?(Stream|Device|Event|Ctx)Synchronize")


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_profile(prof, wall_s: float, frames: int, marker: str,
                   frames_per_marker: float | None = 1,
                   kernel: str = "") -> dict:
    """What ``torch.profiler`` (CUDA activity, which also records the CUDA
    API calls) saw over ``frames`` frames that took ``wall_s`` host
    seconds, ending in a sync.

    ``device_idle_share``: one minus the union of the device's kernels and
    copies over that time; ``device_ops_per_frame``: those operations over
    ``frames``.  ``host_calls_per_frame``: the CUDA API calls that put work
    on the device (launches, graph launches, copies, fills; also by name)
    from the first ``marker`` call to the last, the call that starts each
    ``frames_per_marker`` frames (a graph launch, or the GN kernel's
    launch on the eager loop), over the frames between them: the frame
    loop's steady cost, without the run's set-up (``frames_per_marker``
    None, where a frame's markers vary in number, as an exact frame's
    graph launches do: ``frames`` over the markers seen, a close figure,
    not an exact one); ``host_syncs_per_frame``
    counts the waits for the device in the same span (a readback is one).
    ``kernel_ms``: the mean device time of the kernels whose name holds
    ``kernel`` (None without ``kernel`` or without such a kernel).  Reads
    the profiler's raw events (``prof.events()`` takes seconds at ~10^5
    events).  The device fields are None where the profiler recorded no
    device activity."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if e.device_type() == DeviceType.CUDA]
    picked = [e.duration_ns() for e in events
              if kernel and e.device_type() == DeviceType.CUDA
              and kernel in e.name()]
    api = sorted((e.start_ns(), e.name()) for e in events
                 if e.device_type() == DeviceType.CPU)
    marks = [t for t, name in api if name == marker]
    span = [name for t, name in api
            if len(marks) > 1 and marks[0] <= t < marks[-1]]
    loop = Counter(name for name in span if _SUBMITS.match(name))
    if frames_per_marker is None:
        frames_per_marker = frames / max(len(marks), 1)
    per = max(len(marks) - 1, 0) * frames_per_marker
    busy = union_length(device) / 1e3  # us
    return {
        "device_idle_share": 1.0 - busy / (wall_s * 1e6) if device else None,
        "device_ops_per_frame": len(device) / frames if device else None,
        "kernel_ms": sum(picked) / len(picked) / 1e6 if picked else None,
        "host_calls_per_frame": sum(loop.values()) / per if per else None,
        "host_syncs_per_frame": sum(bool(_SYNCS.match(name))
                                    for name in span) / per if per else None,
        "host_calls_by_name": {k: v / per for k, v in sorted(loop.items())}
        if per else {}}
