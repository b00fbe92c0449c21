"""``offline``: lanes of recordings through ``BatchedOdometryRunner.
run_device`` in chunks.

State is carried between the chunks of a recording, and each pass over
the pool of recordings starts from a fresh runner; the pool repeats until
the window closes, at a chunk's end.  A traced span is one chunk.

Traffic parameters: ``lanes``, ``recording_frames``, ``chunk_frames``
(``recording_frames`` a multiple of it), ``speed_m_per_frame``,
``traced`` (the first and last chunk of the window the profiler covers)
and, if given, a ``catalogue`` of drive ids that fixes the worlds,
trajectories and odometry (``core/generate.py``).
"""

from __future__ import annotations

import re
import time
import warnings

import numpy as np

from icp_bench.core import driving, generate
from icp_bench.core.trace import SPAN_CHUNK

_OVERFLOW = re.compile(r"capacity overflow per sequence \[([0-9, \[\]]*)\]")


class Driver:
    def __init__(self, config, traffic, seed, seconds, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.seconds = seconds
        self.lanes = int(traffic["lanes"])
        self.length = int(traffic["recording_frames"])
        self.chunk = int(traffic["chunk_frames"])
        self.units_per_span = self.chunk
        if self.length % self.chunk:
            raise ValueError("recording_frames must be a multiple of "
                             "chunk_frames")

    def prepare_inputs(self):
        self.pool = generate.drives(
            self.seed, self.lanes, self.length, self.config["sensor"],
            self.config["world"], float(self.traffic["speed_m_per_frame"]),
            self.device, self.traffic.get("catalogue"))

    def input_frames(self):
        return [(d, self.length) for d in self.pool]

    def prepare(self):
        t0 = time.perf_counter()
        self.prepare_inputs()
        self.timing = {"inputs_s": time.perf_counter() - t0}
        from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
        self.runner_type = BatchedOdometryRunner
        self.cfg = driving.port_config(self.config, self.device)
        warm = self._runner()
        self.timing["program_s"] = time.perf_counter() - t0
        warm.run_device(self._chunk(0))
        self.timing["warm_chunk_s"] = time.perf_counter() - t0
        self.passes = []
        self.overflow = 0

    def _runner(self):
        return self.runner_type(self.cfg, self.lanes,
                                extrinsic=self.pool[0]["extrinsic"],
                                device=self.device)

    def _chunk(self, c):
        a, b = c * self.chunk, (c + 1) * self.chunk
        return [{"frames": d["frames"][a:b],
                 "rel_odometry": d["rel_odometry"][a:b]} for d in self.pool]

    def measure(self, traced=None):
        chunks = self.length // self.chunk
        self.done = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stop = False
            while not stop:
                runner = self._runner()
                p = len(self.passes)
                self.passes.append(runner)
                for c in range(chunks):
                    with driving.span(traced, SPAN_CHUNK, p * chunks + c):
                        runner.run_device(self._chunk(c))
                    self.done += self.chunk * self.lanes
                    if time.perf_counter() - t0 >= self.seconds:
                        stop = True
                        break
            end = time.perf_counter()
        for w in caught:
            m = _OVERFLOW.search(str(w.message))
            if m:
                self.overflow += sum(int(x) for x in
                                     re.findall(r"\d+", m.group(1)))
        return t0, end

    def frames(self):
        return self.done

    def metrics(self, start, end):
        return {"frames_per_s": (self.done / (end - start), "frames/s")}

    def notes(self):
        return {"frames": self.done, "passes": len(self.passes),
                **self.timing}

    def answers(self):
        """Every lane of every pass (a cut pass gives its frames so far);
        the window's overflow total is given once."""
        out = []
        for p, runner in enumerate(self.passes):
            poses = getattr(runner, "poses", runner)
            for lane, d in enumerate(self.pool):
                out.append((d, np.asarray(poses[lane]),
                            self.overflow if p == lane == 0 else 0))
        return out

    def release(self):
        self.passes = [getattr(r, "poses", r) for r in self.passes]
