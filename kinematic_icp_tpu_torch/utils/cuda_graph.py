"""One call over fixed buffers, captured once as a CUDA graph and replayed.

The counterpart of a jitted JAX program with donated arguments: the JAX
package compiles a frame once per static shape and runs it as one dispatch
that updates the donated state in place.  Here the owner (a pipeline step,
a server bucket) allocates the buffers once; ``fn`` reads its inputs from
them and writes the new state back into them, and on a CUDA device the
first call captures ``fn`` as a ``torch.cuda.CUDAGraph`` that every later
call replays: one host call in place of the frame's ~1,000 launches, the
same kernels, so the same bits.

Capture follows PyTorch's recipe: ``fn`` is warmed up once on a side
stream, over scratch clones of the buffers (the owner's state is not
advanced), so the kernels are built, the GN kernel's co-resident CTA count
is queried and the allocator has seen the frame before the capture; the
capture then records ``fn`` over the real buffers without running it.  A
capture that fails raises: nothing falls back to the eager call.

The GN kernel's launch counters (``ops.gn``) are plain Python integers
bumped by its wrapper, and a replay runs no Python: the capture records
their increments, every replay adds them, and the warm-up's launches and
the capture's own are taken back out, so a count read around a run is
that run's launches.

Without capture (a CPU device, or an owner that asks for the eager call)
each call runs ``fn`` over the same buffers: the same protocol of copies
in and state written in place, testable on the CPU.
"""

from __future__ import annotations

import time

import torch

from ..ops import gn

#: the GN kernel's counters a replay advances by the captured increments
_ADDITIVE = ("LAUNCHES", "FRAMES", "CROSSING_LAUNCHES")


def _counts():
    return {name: getattr(gn, name) for name in _ADDITIVE + ("LAST_CTAS",)}


class StaticCall:
    """``fn(*buffers)`` over fixed ``buffers``, replayed as a CUDA graph
    when ``capture`` is true (the buffers must then lie on one CUDA
    device), else called eagerly.

    ``fn`` must read nothing back to the host, and its outputs (a tensor
    or a nested tuple of them, returned by every call) live in the graph's
    memory: each call overwrites them.  ``pool`` (``torch.cuda.
    graph_pool_handle()``) lets the graphs of one owner, replayed one at a
    time, share their memory.
    """

    def __init__(self, fn, buffers, capture: bool, pool=None):
        self.fn = fn
        self.buffers = tuple(buffers)
        self.capture = capture
        self.pool = pool
        self.graph = None
        self.outputs = None
        self._increments = {}
        self._last_ctas = None
        #: host ms of the warm-up and the capture (None before them)
        self.capture_ms = None

    def prepare(self):
        """Warm up and capture now (a no-op without capture or once
        captured); touches no buffer."""
        if not self.capture or self.graph is not None:
            return
        dev = self.buffers[0].device
        before = _counts()
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(*(b.clone() for b in self.buffers))
            torch.cuda.current_stream(dev).wait_stream(side)
            warmed = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                self.outputs = self.fn(*self.buffers)
            captured = _counts()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph
        self._increments = {n: captured[n] - warmed[n] for n in _ADDITIVE}
        if self._increments["LAUNCHES"]:
            self._last_ctas = captured["LAST_CTAS"]
        for name, value in before.items():
            setattr(gn, name, value)

    def __call__(self):
        if not self.capture:
            return self.fn(*self.buffers)
        self.prepare()
        self.graph.replay()
        for name, n in self._increments.items():
            setattr(gn, name, getattr(gn, name) + n)
        if self._last_ctas is not None:
            gn.LAST_CTAS = self._last_ctas
        return self.outputs


def refill(buffers, values):
    """Copy each of ``values`` into its buffer (in place, one copy each;
    a value that is its buffer is skipped)."""
    for dst, src in zip(buffers, values):
        if src is not dst:
            dst.copy_(src)
