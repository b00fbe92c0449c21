"""Tracing hooks: the program's spans and counters, and device traces.

The reference has no profiling surface at all (the offline progress bar is
its only throughput signal).  This module gives the port three things:

* ``span(name)``: a host span at a layer boundary (``kicp.register_frame``,
  ``kicp.pack``, ``kicp.upload``, ``kicp.launch``, ``kicp.readback``,
  ``kicp.run_device``, ``kicp.pad_batch``, ``kicp.frames``).  While a
  ``torch.profiler`` runs it is a host event of the profiler's trace, in a
  record-function scope that the profiler does not mirror onto the
  device's timeline (a user-scope ``record_function`` also leaves a
  ``gpu_user_annotation`` there, which would read as device time).
  Inside ``recording()`` it is a sample of this module's buffer.  With
  neither it costs one check of the profiler's flag and of
  ``recording()``'s depth, and allocates nothing.
* ``count(name, **values)``: a sample of counts the program read back at a
  sync it makes anyway (the GN passes, live sources, exact fallbacks and
  their full-27 loop trips of ``"gn"``), kept while recording is on (a
  profiler runs, or inside ``recording()``) and dropped otherwise.
* ``samples(name, lo_ns, hi_ns)``: the buffer's samples of ``name`` in a
  window of ``time.time_ns()``, the clock of the profiler's host events.

The buffer keeps the last ``BUFFER_SAMPLES`` samples.  ``device_trace``
wraps ``torch.profiler`` for a Chrome trace, and ``device_profile`` reads
a profiler's device activity.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import Counter, deque

import torch

#: the samples the buffer keeps, oldest dropped first
BUFFER_SAMPLES = 1 << 16
#: (name, time.time_ns(), values) of each count, and (name, start_ns,
#: {"end_ns": end_ns}) of each span recorded inside ``recording()``
_buffer: deque = deque(maxlen=BUFFER_SAMPLES)
#: depth of the ``recording()`` blocks open
_recording = 0
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The span while nothing records: one object, shared."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "event", "start_ns")

    def __init__(self, name: str):
        self.name = name
        self.event = None
        self.start_ns = 0

    def __enter__(self):
        if _profiler_enabled():
            # the FUNCTION scope: a host event only, no device shadow
            self.event = torch._C._profiler._RecordFunctionFast(self.name)
            self.event.__enter__()
        if _recording:
            self.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        if _recording and self.start_ns:
            _buffer.append((self.name, self.start_ns,
                            {"end_ns": time.time_ns()}))
        if self.event is not None:
            self.event.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks the host's time inside it as ``name``
    while recording is on (see the module's docstring); a shared no-op
    object otherwise."""
    if _recording or _profiler_enabled():
        return _Span(name)
    return _OFF


def count(name: str, **values) -> None:
    """Keep ``values`` (numbers) as a sample of ``name`` at
    ``time.time_ns()`` while recording is on; nothing otherwise."""
    if _recording or _profiler_enabled():
        _buffer.append((name, time.time_ns(), values))


def samples(name: str, lo_ns: int = 0, hi_ns: int | None = None) -> list:
    """(time_ns, values) of the buffer's samples of ``name`` with
    ``lo_ns <= time_ns <= hi_ns``, oldest first."""
    return [(t, v) for n, t, v in list(_buffer)
            if n == name and lo_ns <= t and (hi_ns is None or t <= hi_ns)]


@contextlib.contextmanager
def recording():
    """Record spans and counts into the buffer inside the block, with no
    profiler (nested blocks record until the outermost ends)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


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
