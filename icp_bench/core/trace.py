"""What a traced run hands to the per-layer metric readers.

``Trace`` holds the profiled sub-window of a run: the device's operations,
the host's operations and the benchmark's own spans, all on the
profiler's clock in nanoseconds.  ``union_length`` is a frozen copy of
``kinematic_icp_tpu_torch/utils/profiling.union_length`` at commit
dc36a2491db637ba74eeae484c593953a0d99c15: a device is busy where any of
its kernels, copies or fills runs.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

#: span names the benchmark records around the program's entry points
SPAN_FRAME = "icp_bench.frame"
SPAN_CHUNK = "icp_bench.chunk"
#: a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    config: dict            # the configuration file, as loaded
    traffic: dict           # the traffic file, as loaded
    #: (name, start_ns, end_ns) of every device operation
    device: list
    #: (name, start_ns, end_ns) of every host operation the profiler saw
    host: list
    #: (name, start_ns, end_ns) of the benchmark's spans
    spans: list
    #: (start_ns, end_ns) of the traced window
    window: tuple
    #: frames (live) or batched frames (offline) inside the window
    units: int


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


def clipped(events, lo, hi):
    """(start, end) of the events inside [lo, hi], cut to it."""
    return [(max(s, lo), min(e, hi)) for _, s, e in events
            if e > lo and s < hi]


def busy_ns(events, lo, hi) -> float:
    return union_length(clipped(events, lo, hi))


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _cover(events, starts, t, depth=64):
    """Name of the latest-starting of ``events`` (sorted by start, whose
    starts are ``starts``) that covers time ``t``; None if none of the
    ``depth`` that start last before ``t`` does."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(events[max(0, i - depth):i]):
        if e > t:
            return name
    return None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device by what the host was doing (the innermost host operation, else
    the benchmark's span, over the middle of the gap), each summed by name
    in seconds, at most ``top`` of each."""
    lo, hi = trace.window
    ops = defaultdict(float)
    for name, s, e in trace.device:
        if e > lo and s < hi:
            ops[name] += (min(e, hi) - max(s, lo)) / 1e9
    host = sorted(trace.host, key=lambda x: x[1])
    spans = sorted(trace.spans, key=lambda x: x[1])
    host_starts = [s for _, s, _ in host]
    span_starts = [s for _, s, _ in spans]
    gaps = defaultdict(float)
    cursor = lo
    for s, e in merged(clipped(trace.device, lo, hi)) + [[hi, hi]]:
        if s > cursor:
            mid = 0.5 * (cursor + s)
            label = (_cover(host, host_starts, mid)
                     or _cover(spans, span_starts, mid) or "between spans")
            gaps[label] += (s - cursor) / 1e9
        cursor = max(cursor, e)

    def first(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])][:top]

    return {"device_ops": first(ops), "idle_gaps": first(gaps)}
