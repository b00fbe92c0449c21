"""One call over fixed buffers, captured once as a CUDA graph and replayed.

The counterpart of a jitted JAX program with donated arguments: the JAX
package compiles a frame once per static shape and runs it as one dispatch
that updates the donated state in place.  Here the owner (a pipeline step,
a server bucket) allocates the buffers once; ``fn`` reads its inputs from
them and writes the new state back into them, and on a CUDA device the
first call captures ``fn`` as one CUDA graph that every later call
replays: one host call in place of the frame's ~1,000 launches, the same
kernels, so the same bits.

A frame's data-dependent control flow stays on the device, where JAX's
``lax.cond`` and ``lax.while_loop`` keep it, as CUDA-graph conditional (IF)
nodes:

* ``when(pred, body)``: ``body()`` runs where the 0-d bool ``pred`` is set
  (the GN loop's trips and re-associations, ``ops.registration.run_gn``);
* ``branch(flag, fallback, tensors)``: ``tensors`` rewritten in place by
  ``fallback()`` where some row of ``flag`` is set (the exact modes'
  full-27 fallback), an IF node on ``flag.any()``.

Under capture each becomes an IF node whose body graph is captured from
``body`` (an IF node inside it where bodies nest), so a frame is one graph
and a replay reads nothing back.  The node is built by the port's own
``csrc/graph_if.cu`` through the CUDA runtime (a kernel that sets the
node's handle from the predicate at each replay, the node, and the body's
capture into its graph on a stream of its own, whose allocations go to a
memory pool of its nesting depth, held as long as the graph).  A body runs
on the replays whose predicate is set and not on the others, so whatever
the frame reads after it must be written into tensors that exist before it
(``copy_``): a tensor the body creates is garbage on a replay that skips
it.  A capture that
cannot build its IF node raises: nothing falls back to a read-back or to
the eager call.

Without capture (a CPU device, an owner that asks for the eager call, and
the warm-up before a capture) ``when`` always runs its body and reads
nothing back, so a body run where its predicate is clear must change
nothing (a masked trip); ``branch`` reads its flag back once and runs the
fallback only where some row is set (the eager baseline's one read-back).

Capture follows PyTorch's recipe: ``fn`` is warmed up once on a side
stream, over scratch clones of the buffers (the owner's state is not
advanced), with every body run, so the kernels are built, the GN kernel's
co-resident CTA count is queried, a process group's communicator is made
and the allocator has seen the frame before the capture; the capture then
records ``fn`` over the real buffers without running it.  Python's cyclic
garbage collector is held off during the capture: a graph left in a
reference cycle by an earlier owner, collected mid-capture, resets itself,
which a capturing stream refuses, and the capture fails.  (A full
collection before each capture, as ``torch.cuda.graph`` runs, added 0.2-0.6
s a capture in ``chip_smoke.py`` on an H100.)  A capture that fails
raises: nothing falls back to the eager call.

The launch and collective counters are plain Python integers bumped where
the work is issued, and a replay runs no Python.  So each module that owns
such a counter registers it here at import time (``replayed``): the
capture records the counters' increments and the last values it set, every
replay adds and sets them again, and the warm-up's and the capture's own
are taken back out, so a count read around a run is that run's.  A replay
cannot tell whether an IF body ran, so a capture that moves a registered
counter inside a body raises: such work is counted on the device.

A captured frame that issues collectives holds its process group's
communicator until its graph is freed (``StaticCall.release``).
"""

from __future__ import annotations

import ctypes
import gc
import sys
import time
import weakref

import torch

from . import profiling

#: the capture in progress (``_Capture``), or ``_WARMUP`` during a
#: warm-up, else None
_active = None
_WARMUP = object()
_UNSET = object()

#: (module, name) of each counter a replay advances by what its capture
#: added, and of each value a replay sets to what its capture left
_COUNTERS = []
_LATEST = []

#: launches of ``csrc/graph_if.cu``'s kernel that captures recorded (one an
#: IF node, nested ones too; a plain count that no replay advances: each
#: replay runs the kernel of every node its bodies reach)
IF_LAUNCHES = 0


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


class _Capture:
    """A static call's capture in progress, and its IF nodes: each body is
    captured on a stream of its nesting depth, whose allocations the
    caching allocator routes to a memory pool of that depth while the
    capture lasts (PyTorch routes only the capturing stream's, and refuses
    a second route to the graph's own pool).  The pools hold the bodies'
    memory for as long as the graph lives (``_free_pools``).  The nodes
    themselves are built by ``csrc/graph_if.cu`` through the CUDA runtime:
    PyTorch before 2.13 has no call that captures into one."""

    def __init__(self, dev):
        self.dev = dev
        #: the bodies' memory pools, one a depth
        self.pools = []
        #: the body streams, one a depth, and those of the open nodes
        self._streams, self._open = [], []
        self._lib = None

    def begin_if(self, pred):
        """Open an IF node on ``pred`` (a bool on the card) on the current
        stream; returns the stream to capture its body on."""
        global IF_LAUNCHES
        if self._lib is None:
            from ..ops import cuda_build

            self._lib = cuda_build.load("graph_if")
            for fn in (self._lib.kicp_if_begin, self._lib.kicp_if_end):
                fn.restype = ctypes.c_int
            self._lib.kicp_if_begin.argtypes = [ctypes.c_void_p] * 3
            self._lib.kicp_if_end.argtypes = [ctypes.c_void_p]
        depth = len(self._open)
        if depth == len(self._streams):
            body = torch.cuda.Stream(self.dev)
            pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(body):
                torch._C._cuda_beginAllocateCurrentStreamToPool(
                    self.dev.index, pool)
            self._streams.append(body)
            self.pools.append(pool)
        body = self._streams[depth]
        if pred.device != self.dev:
            raise ValueError(f"when: a predicate on {pred.device} in a "
                             f"capture on {self.dev}")
        rc = self._lib.kicp_if_begin(
            torch.cuda.current_stream(self.dev).cuda_stream,
            pred.data_ptr(), body.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"capturing a conditional node failed: CUDA "
                               f"error {rc}")
        IF_LAUNCHES += 1
        self._open.append(body)
        return body

    def end_if(self):
        """Close the innermost open IF node's body."""
        rc = self._lib.kicp_if_end(self._open.pop().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ending a conditional node's capture "
                               f"failed: CUDA error {rc}")

    def close(self):
        """Stop routing the body streams' allocations; the pools stay."""
        for pool in self.pools[:len(self._streams)]:
            torch._C._cuda_endAllocateToPool(self.dev.index, pool)
        self._streams = []


def _free_pools(dev, pools):
    """Hand the IF bodies' memory ``pools`` back to the allocator, once no
    graph that uses them will replay."""
    for pool in pools:
        torch._C._cuda_releasePool(dev.index, pool)


def when(pred, body):
    """``body()`` where the 0-d bool tensor ``pred`` is set.  ``body``
    returns nothing: it writes what it computes into tensors that exist
    before it.  Under a static call's capture an IF node on ``pred``,
    whose body graph is captured from ``body``; otherwise ``body()``
    runs, reading nothing back, so a body run where ``pred`` is clear
    must change nothing."""
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"when: a one-element bool predicate, got "
                         f"{pred.dtype} {tuple(pred.shape)}")
    capture = _active
    if capture is None or capture is _WARMUP:
        body()
        return
    before = {**_counts(), **_latest()}
    stream = capture.begin_if(pred)
    try:
        with torch.cuda.stream(stream):
            body()
    finally:
        capture.end_if()
    if {**_counts(), **_latest()} != before:
        raise RuntimeError(
            "a registered counter moved inside a conditional body, where "
            "a replay cannot tell whether it ran: count it on the device")


def branch(flag, fallback, tensors):
    """A branch point of a frame: ``tensors`` (a tuple) as they are, or
    ``fallback()``'s new values of them (a tuple of the same shapes, which
    must keep each row whose ``flag`` is clear), computed only where some
    row of the (B,) or 0-d bool ``flag`` is set.

    Eager: one read-back of ``flag.any()``, then the fallback if set, its
    values returned.  In a static call's warm-up and capture: ``when`` on
    ``flag.any()`` over a body that copies the fallback's values into
    ``tensors``, which are returned (under capture an IF node: no
    read-back).
    """
    if _active is None:
        return fallback() if bool(flag.any()) else tensors

    def body():
        for dst, src in zip(tensors, fallback()):
            dst.copy_(src)

    when(flag.any(), body)
    return tensors


class StaticCall:
    """``fn(*buffers)`` over fixed ``buffers``, replayed as one CUDA graph
    when ``capture`` is true (the buffers must then lie on one CUDA
    device), else called eagerly.

    ``fn`` must read nothing back to the host (its data-dependent control
    flow goes through ``when`` and ``branch``), and its outputs (a tensor
    or a nested tuple of them, returned by every call) live in the graph's
    memory: each call overwrites them.  ``pool``
    (``torch.cuda.graph_pool_handle()``) lets the graphs of one owner,
    replayed one at a time, share their memory.
    """

    def __init__(self, fn, buffers, capture: bool, pool=None):
        self.fn = fn
        self.buffers = tuple(buffers)
        self.capture = capture
        self.pool = pool
        self.outputs = None
        self._graph = None
        self._effects = None
        #: the memory pools of the graph's IF bodies (empty without them)
        self.body_pools = []
        self._free_pools = None
        #: host ms of the warm-up and the capture (None before them)
        self.capture_ms = None

    @property
    def graphs(self) -> int:
        """CUDA graphs captured: 1, or 0 before the capture and without
        capture."""
        return int(self._graph is not None)

    def prepare(self):
        """Warm up and capture now (a no-op without capture or once
        captured); touches no buffer."""
        global _active
        if not self.capture or self._graph is not None:
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
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                effects = _Effects()
                graph.capture_begin(pool=pool)
                capture = _active = _Capture(dev)
                try:
                    outputs = self.fn(*self.buffers)
                except BaseException:
                    try:  # end the capture the failure left open
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the failure is re-raised
                    capture.close()
                    _free_pools(dev, capture.pools)
                    raise
                else:
                    graph.capture_end()
                    effects.end()
                finally:
                    _active = None
                    capture.close()
                    _set(before)
                    if collecting:
                        gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.outputs, self._graph, self._effects = outputs, graph, effects
        self.body_pools = capture.pools
        self._free_pools = weakref.finalize(self, _free_pools, dev,
                                            capture.pools)

    def release(self):
        """Free the graph now (a later call captures again): a graph that
        issues collectives holds its group's communicator until then."""
        if self._graph is not None:
            self._graph.reset()
            self._free_pools()
        self.outputs = self._graph = self._effects = None
        self.body_pools = []

    def __call__(self):
        if not self.capture:
            return self.fn(*self.buffers)
        self.prepare()
        with profiling.span("kicp.launch"):
            self._graph.replay()
            self._effects.apply()
        return self.outputs


def refill(buffers, values):
    """Copy each of ``values`` into its buffer (in place, one copy each;
    a value that is its buffer is skipped)."""
    for dst, src in zip(buffers, values):
        if src is not dst:
            dst.copy_(src)
