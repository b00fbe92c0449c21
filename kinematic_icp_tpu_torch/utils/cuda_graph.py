"""One call over fixed buffers, captured once as CUDA graphs and replayed.

The counterpart of a jitted JAX program with donated arguments: the JAX
package compiles a frame once per static shape and runs it as one dispatch
that updates the donated state in place.  Here the owner (a pipeline step,
a server bucket) allocates the buffers once; ``fn`` reads its inputs from
them and writes the new state back into them, and on a CUDA device the
first call captures ``fn`` as CUDA graphs that every later call replays:
one host call in place of the frame's ~1,000 launches, the same kernels,
so the same bits.

A frame may hit branch points (``branch``): a (B,) flag, a fallback that
recomputes some tensors, and those tensors.  This is where JAX's frame runs
a device-side ``lax.cond`` (the exact modes' full-27 fallback); eager
PyTorch has no such branch, so the frame is captured as a chain: segment 0
up to the first branch point, ending in ``flag.any()``; a graph of the
fallback of its own, writing its values into the branch point's tensors in
place; the next segment up to the next branch point, or to the end.  A
replay runs segment 0, copies the flag into pinned host memory and waits
for it (the frame's one read-back a branch point), replays the fallback's
graph only if some row is set, then the next segment.  Every graph of a
chain shares one memory pool and replays in capture order; a fallback
graph writes only into tensors that exist before it, so the memory of its
temporaries is dead once it ends whether or not it ran.

Capture follows PyTorch's recipe: ``fn`` is warmed up once on a side
stream, over scratch clones of the buffers (the owner's state is not
advanced), with every fallback run, so the kernels are built, the GN
kernel's co-resident CTA count is queried, a process group's communicator
is made and the allocator has seen the frame before the capture; the
capture then records ``fn`` over the real buffers without running it.
Python's cyclic garbage collector is held off during the capture: a graph
left in a reference cycle by an earlier owner, collected mid-capture,
resets itself, which a capturing stream refuses, and the capture fails.
(A full collection before each capture, as ``torch.cuda.graph`` runs,
added 0.2-0.6 s a capture in ``chip_smoke.py`` on an H100.)  A capture that
fails raises: nothing falls back to the eager call.

The launch, fallback and collective counters are plain Python integers
bumped where the work is issued, and a replay runs no Python.  So each
module that owns such a counter registers it here at import time
(``replayed``): each graph's capture records the counters' increments and
the last values it set, every replay of it adds and sets them again, and
the warm-up's and the capture's own are taken back out, so a count read
around a run is that run's.

Without capture (a CPU device, or an owner that asks for the eager call)
each call runs ``fn`` over the same buffers, and a branch point reads its
flag back and runs the fallback where set: the same protocol, testable on
the CPU.

A captured frame that issues collectives holds its process group's
communicator until its graphs are freed (``StaticCall.release``).
"""

from __future__ import annotations

import gc
import sys
import time

import torch

#: the chain being captured, or ``_WARMUP`` during a warm-up, else None
_active = None
_WARMUP = object()
_UNSET = object()

#: (module, name) of each counter a replay advances by what its capture
#: added, and of each value a replay sets to what its capture left
_COUNTERS = []
_LATEST = []


def replayed(module_name: str, counters=(), latest=()):
    """Register module ``module_name``'s integer ``counters``, which each
    replay advances by what its capture added, and its ``latest`` values,
    which each replay sets to what its capture left (called by the owning
    module at import time)."""
    module = sys.modules[module_name]
    _COUNTERS.extend((module, n) for n in counters)
    _LATEST.extend((module, n) for n in latest)


def _counts():
    return {k: getattr(*k) for k in _COUNTERS}


def _latest():
    return {k: getattr(*k) for k in _LATEST}


def _set(values):
    for (module, name), v in values.items():
        setattr(module, name, v)


class _Effects:
    """What a graph's capture did to the registered counters and values,
    recorded from its making (at the capture's start) to ``end``;
    ``apply`` does it again at a replay."""

    def __init__(self):
        self._before = _counts()
        _set(dict.fromkeys(_LATEST, _UNSET))

    def end(self):
        self.added = {k: v - self._before[k] for k, v in _counts().items()
                      if v != self._before[k]}
        self.left = {k: v for k, v in _latest().items() if v is not _UNSET}
        return self

    def apply(self):
        for (module, name), n in self.added.items():
            setattr(module, name, getattr(module, name) + n)
        _set(self.left)


def branch(flag, fallback, tensors):
    """A branch point of a frame: ``tensors`` (a tuple) as they are, or
    ``fallback()``'s new values of them (a tuple of the same shapes, which
    must keep each row whose ``flag`` is clear), run only where some row of
    the (B,) or 0-d bool ``flag`` is set.

    Eager: one read-back of ``flag.any()``, then the fallback if set.  In a
    static call's warm-up the fallback always runs; under its capture the
    fallback becomes a graph of its own that writes into ``tensors`` in
    place, replayed on the frames whose flag reads back set (see the
    module's docstring).
    """
    if _active is None:
        return fallback() if bool(flag.any()) else tensors
    if _active is _WARMUP:
        return fallback()
    return _active.branch(flag, fallback, tensors)


class _Chain:
    """The graphs of one capture: ``segments`` (graph, effects), and
    between each two a branch point's (``flag.any()`` on the device, its
    pinned host copy, fallback graph, effects)."""

    def __init__(self, pool):
        self.pool = pool
        self.segments = []
        self.branches = []
        self._begin()

    def _begin(self):
        self._graph, self._effects = torch.cuda.CUDAGraph(), _Effects()
        self._graph.capture_begin(pool=self.pool)

    def _end(self):
        graph, self._graph = self._graph, None
        graph.capture_end()
        return graph, self._effects.end()

    def end(self):
        self.segments.append(self._end())

    def abort(self):
        """End a capture left open by a failure (which the caller
        re-raises)."""
        if self._graph is not None:
            try:
                self._graph.capture_end()
            except RuntimeError:
                pass
            self._graph = None

    def branch(self, flag, fallback, tensors):
        any_set = flag.any()
        self.end()
        self._begin()
        values = fallback()
        for dst, src in zip(tensors, values):
            dst.copy_(src)
        del values
        graph, effects = self._end()
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        self.branches.append((any_set, host, graph, effects))
        self._begin()
        return tensors


class StaticCall:
    """``fn(*buffers)`` over fixed ``buffers``, replayed as CUDA graphs
    when ``capture`` is true (the buffers must then lie on one CUDA
    device), else called eagerly.

    ``fn`` must read nothing back to the host outside its branch points
    (``branch``), and its outputs (a tensor or a nested tuple of them,
    returned by every call) live in the graphs' memory: each call
    overwrites them.  ``pool`` (``torch.cuda.graph_pool_handle()``) lets
    the graphs of one owner, replayed one at a time, share their memory.
    """

    def __init__(self, fn, buffers, capture: bool, pool=None):
        self.fn = fn
        self.buffers = tuple(buffers)
        self.capture = capture
        self.pool = pool
        self.outputs = None
        self._chain = None
        #: host ms of the warm-up and the capture (None before them)
        self.capture_ms = None

    @property
    def graphs(self) -> int:
        """CUDA graphs captured: the segments and the fallbacks between
        them (0 before the capture, or without capture)."""
        if self._chain is None:
            return 0
        return len(self._chain.segments) + len(self._chain.branches)

    def prepare(self):
        """Warm up and capture now (a no-op without capture or once
        captured); touches no buffer."""
        global _active
        if not self.capture or self._chain is not None:
            return
        dev = self.buffers[0].device
        before = {**_counts(), **_latest()}
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _active = _WARMUP
                try:
                    self.fn(*(b.clone() for b in self.buffers))
                finally:
                    _active = None
            torch.cuda.current_stream(dev).wait_stream(side)
            # as torch.cuda.graph frees what it can before a capture
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            pool = (self.pool if self.pool is not None
                    else torch.cuda.graph_pool_handle())
            collecting = gc.isenabled()
            gc.disable()
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                chain = _active = _Chain(pool)
                try:
                    outputs = self.fn(*self.buffers)
                    chain.end()
                except BaseException:
                    chain.abort()
                    raise
                finally:
                    _active = None
                    _set(before)
                    if collecting:
                        gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.outputs, self._chain = outputs, chain

    def release(self):
        """Free the graphs now (a later call captures again): a graph that
        issues collectives holds its group's communicator until then."""
        if self._chain is not None:
            for graph, _ in self._chain.segments:
                graph.reset()
            for _, _, graph, _ in self._chain.branches:
                graph.reset()
        self.outputs = self._chain = None

    def __call__(self):
        if not self.capture:
            return self.fn(*self.buffers)
        self.prepare()
        segments, branches = self._chain.segments, self._chain.branches
        for i, (graph, effects) in enumerate(segments):
            if i:
                any_set, host, fallback, more = branches[i - 1]
                host.copy_(any_set, non_blocking=True)
                torch.cuda.current_stream().synchronize()
                if host.item():
                    fallback.replay()
                    more.apply()
            graph.replay()
            effects.apply()
        return self.outputs


def refill(buffers, values):
    """Copy each of ``values`` into its buffer (in place, one copy each;
    a value that is its buffer is skipped)."""
    for dst, src in zip(buffers, values):
        if src is not dst:
            dst.copy_(src)
