"""``live``: one sensor's scans through ``LidarOdometryServer.register_frame
(blocking=True)``, open loop at the sensor's rate.

A frame's latency runs from its due time on the sensor's schedule to the
call's return.  The sender sleeps until ``SPIN_S`` before each due time
and waits out the rest on the clock.  Besides the latencies it records,
for each frame, how late it was sent and how often the host switched the
sending thread out against its will (while it waited or inside the
call), so that a slow run can be told from a slow program.

Traffic parameters: ``rate_hz``, ``warmup_frames``, ``codec``,
``speed_m_per_frame`` and ``traced`` (the first and last frame of the
window the profiler covers); a ``catalogue`` of drive ids, if given,
fixes the world and the trajectory (``core/generate.py``).
"""

from __future__ import annotations

import resource
import time

import numpy as np

from icp_bench.core import driving, generate
from icp_bench.core.trace import SPAN_FRAME

_RUSAGE = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)
#: the sender waits out the last 2 ms before a due time on the clock
SPIN_S = 0.002


def _switched_out() -> int:
    """Involuntary context switches of this thread so far."""
    return resource.getrusage(_RUSAGE).ru_nivcsw


class Driver:
    units_per_span = 1

    def __init__(self, config, traffic, seed, seconds, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.rate = float(traffic["rate_hz"])
        self.warm = int(traffic["warmup_frames"])
        self.count = int(round(seconds * self.rate))

    def prepare_inputs(self):
        self.drive = generate.drives(
            self.seed, 1, self.warm + self.count, self.config["sensor"],
            self.config["world"], float(self.traffic["speed_m_per_frame"]),
            self.device, self.traffic.get("catalogue"))[0]

    def input_frames(self):
        return [(self.drive, self.warm + self.count)]

    def prepare(self):
        t = self.traffic
        t0 = time.perf_counter()
        self.prepare_inputs()
        self.timing = {"inputs_s": time.perf_counter() - t0}
        from kinematic_icp_tpu_torch.server import (LidarOdometryServer,
                                                    next_bucket)
        cfg = driving.port_config(self.config, self.device)
        self.server = LidarOdometryServer(
            cfg, extrinsic=self.drive["extrinsic"], upload=t["codec"],
            device=self.device)
        for b in sorted({next_bucket(len(p), cfg.max_points)
                         for p, _ in self.drive["frames"]}):
            self.server.warmup(b)
        self.timing["program_s"] = time.perf_counter() - t0
        self.poses = []
        for k in range(self.warm):
            self._frame(k)
        self.timing["warm_frames_s"] = time.perf_counter() - t0

    def _frame(self, k):
        pts, ts = self.drive["frames"][k]
        out = self.server.register_frame(
            pts, ts, self.drive["rel_odometry"][k], stamp=k / self.rate,
            blocking=True)
        self.poses.append(out["pose"])

    def measure(self, traced=None):
        period = 1.0 / self.rate
        self.latency, self.late, self.switched = [], [], []
        t0 = time.perf_counter() + 0.01
        for i in range(self.count):
            due = t0 + i * period
            n0 = _switched_out()
            now = time.perf_counter()
            if due - now > SPIN_S:
                time.sleep(due - now - SPIN_S)
            while time.perf_counter() < due:
                pass
            start = time.perf_counter()
            self.late.append(start - due)
            with driving.span(traced, SPAN_FRAME, i):
                self._frame(self.warm + i)
            self.latency.append(time.perf_counter() - due)
            self.switched.append(_switched_out() - n0)
        return t0, t0 + (self.count - 1) * period + self.latency[-1]

    def frames(self):
        return self.count

    def metrics(self, start, end):
        lat = np.asarray(self.latency) * 1e3
        return {"latency_p50_ms": (float(np.percentile(lat, 50)), "ms"),
                "latency_p95_ms": (float(np.percentile(lat, 95)), "ms")}

    def notes(self):
        lat = np.asarray(self.latency) * 1e3
        late = np.asarray(self.late) * 1e3
        switched = np.asarray(self.switched)
        calm = lat[switched == 0]
        slowest = np.argsort(lat)[::-1][:5]
        return {"frames": self.count,
                "latency_p95_ms": float(np.percentile(lat, 95)),
                "send_late_ms_max": float(late.max()),
                "send_late_ms_p95": float(np.percentile(late, 95)),
                "switched_out_frames": int(np.count_nonzero(switched)),
                "latency_p95_ms_never_switched_out":
                    float(np.percentile(calm, 95)) if calm.size else None,
                "slowest_ms_late_ms_switches": [
                    [float(lat[i]), float(late[i]), int(switched[i])]
                    for i in slowest],
                **getattr(self, "timing", {})}

    def answers(self):
        ovf = self.server.overflow_stats
        return [(self.drive, np.asarray(self.poses),
                 int(sum(ovf.values())))]

    def release(self):
        del self.server
