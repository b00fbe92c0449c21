"""``bag``: the reference's offline node over a recorded drive, a ROS 2
MCAP bag written at set-up and replayed through ``run_odometry.main``.

Set-up renders one drive of ``frames`` scans from the mounted sensor's
pose (the base's pose composed with the configuration's extrinsic) and
writes it with ``core/rosbag.py`` as the configuration's ``bag`` says:
the scans as PointCloud2 on the lidar topic, stamped at their first
firing with each point's time from it; the wheel odometry as
``odom -> base_link`` on ``/tf``, with one sample at each scan's end
stamp as the reference's ``TimeStampHandler`` computes it, so that the
odometry between two scans' end stamps is the drive's; the extrinsic on
``/tf_static``; chunks compressed as it says.  The shipped parameter file
is written beside it, and one untimed pass builds the native library and
the kernels and captures the graphs.

A pass of the window is one in-process ``run_odometry.main([bag,
"--config", yaml, "--output-dir", dir, "--no-progress", "--device",
device, "--max-points", n])``: the CLI's normal path, a fresh server each
pass, as a user's invocation less the process's start.  It runs closed
loop (the next message is read as soon as the last frame returns), and
passes repeat until the window closes, at a pass's end.  A traced span is
one pass.  Without PyYAML the pass gives no ``--config``: the CLI's
defaults are the shipped file's values.

The reference gets the drive's scans with their per-point times
normalised as ``TimeStampHandler.cpp:130-135`` does (computed here), the
drive's odometry and the extrinsic.

Traffic parameters: ``frames``, ``speed_m_per_frame``, ``catalogue`` (the
drive ids the seed picks the place from, as ``core/generate.py`` does)
and ``traced`` (the first and last pass of the window the profiler
covers).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import math
import os
import shutil
import tempfile
import time

import numpy as np

from icp_bench.core import driving, generate, rosbag, world

#: the benchmark's span around a pass
SPAN_PASS = "icp_bench.pass"
_FIELD_TYPES = {"float32": (rosbag.FLOAT32, "<f4"),
                "uint16": (rosbag.UINT16, "<u2")}


def _planar(T):
    return (T[0, 3], T[1, 3], math.atan2(T[1, 0], T[0, 0]))


def _yaw_quaternion(yaw):
    return (0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2))


def normalised_times(times):
    """(end offset from the header stamp, normalised per-point times):
    the span of the float32 times read as float64, and each time's share
    of it in float32 (TimeStampHandler.cpp:115-135, a begin-stamped
    scan)."""
    t = np.asarray(times, np.float32).astype(np.float64)
    lo, hi = float(np.min(t)), float(np.max(t))
    return hi - lo, ((t - lo) / (hi - lo)).astype(np.float32)


def read_tum(path):
    """(stamps (F,), poses (F, 4, 4)) of a TUM file."""
    rows = np.loadtxt(path, ndmin=2)
    stamps, t, q = rows[:, 0], rows[:, 1:4], rows[:, 4:8]
    x, y, z, w = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    poses = np.zeros((len(rows), 4, 4))
    poses[:, 0] = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                            2 * (x * z + y * w), t[:, 0]], -1)
    poses[:, 1] = np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                            2 * (y * z - x * w), t[:, 1]], -1)
    poses[:, 2] = np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                            1 - 2 * (x * x + y * y), t[:, 2]], -1)
    poses[:, 3, 3] = 1.0
    return stamps, poses


def yaml_text(parameters: dict) -> str:
    """The parameter file of the offline node: ``/**: ros__parameters:``."""
    def value(v):
        return str(v).lower() if isinstance(v, bool) else repr(v)
    return "/**:\n  ros__parameters:\n" + "".join(
        f"    {k}: {value(v)}\n" for k, v in parameters.items())


class Driver:
    def __init__(self, config, traffic, seed, seconds, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.seconds = seconds
        self.count = int(traffic["frames"])
        self.units_per_span = self.count
        self.dir = None
        self.passes = []

    # -- inputs ----------------------------------------------------------
    def prepare_inputs(self):
        import torch

        bag, sensor = self.config["bag"], self.config["sensor"]
        ext = np.eye(4)
        ext[:3, 3] = bag["extrinsic_xyz_m"]
        if abs(ext[2, 3] - float(sensor["height_m"])) > 1e-12:
            raise ValueError("the extrinsic's height is the renderer's "
                             "sensor height")
        catalogue = self.traffic["catalogue"]
        order = np.random.default_rng([self.seed, 4]).permutation(
            len(catalogue))
        place = int(catalogue[order[0]])
        p = generate.plan(self.seed, place, self.count, self.config["world"],
                          float(self.traffic["speed_m_per_frame"]), 0)
        ends = np.asarray([_planar(g @ ext) for g in p["gt_poses"]])
        starts = np.concatenate([ends[:1], ends[:-1]])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.default_rng(
            [self.seed, place, 3]).integers(2**62)))
        scans = world.render_scans(p["segments"], p["wall_height"],
                                   world.lidar_from_spec(sensor), starts,
                                   ends, gen, self.device)
        duration = float(sensor["scan_duration_s"])
        self.times, frames, spans = [], [], []
        for pts, ts in scans:
            times = (ts.astype(np.float64) * duration).astype(np.float32)
            span, norm = normalised_times(times)
            self.times.append(times)
            frames.append((pts, norm))
            spans.append(span)
        self.spans = spans
        self.drive = {"frames": frames, "rel_odometry": p["rel_odometry"],
                      "gt_poses": p["gt_poses"], "extrinsic": ext}
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def input_frames(self):
        return [(self.drive, self.count)]

    # -- the bag -----------------------------------------------------------
    def _points(self, k):
        """Scan ``k`` as the sensor's point records."""
        bag = self.config["bag"]
        pts = self.drive["frames"][k][0]
        fields = bag["fields"]
        rec = np.zeros(len(pts), np.dtype({
            "names": [f[0] for f in fields],
            "formats": [_FIELD_TYPES[f[2]][1] for f in fields],
            "offsets": [f[1] for f in fields],
            "itemsize": int(bag["point_step"])}))
        rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        planar = np.hypot(pts[:, 0], pts[:, 1]).astype(np.float64)
        rec["intensity"] = np.round(255.0 * np.clip(
            1.0 - planar / float(self.config["sensor"]["max_range_m"]),
            0.0, 1.0))
        rec["ring"] = self._ring(pts[:, 2] / np.maximum(planar, 1e-9))
        rec["time"] = self.times[k]
        return rec

    def _ring(self, slope):
        """Index of the ring whose elevation is nearest each point's."""
        s = self.config["sensor"]
        tan = np.tan(np.deg2rad(np.linspace(float(s["elevation_min_deg"]),
                                            float(s["elevation_max_deg"]),
                                            int(s["rings"]))))
        mid = 0.5 * (tan[1:] + tan[:-1])
        return np.searchsorted(mid, slope)

    def write_bag(self, path):
        """The drive as a bag at ``path``: returns (stamps of the scans'
        ends, bytes of the messages, bytes of the file)."""
        bag = self.config["bag"]
        odom, base = bag["odom_frame"], bag["base_frame"]
        period_ns = int(round(1e9 / float(bag["scan_rate_hz"])))
        tf_ns = int(round(1e9 / float(bag["tf_rate_hz"])))
        fields = [(f[0], f[1], _FIELD_TYPES[f[2]][0]) for f in bag["fields"]]
        heads = [int(bag["start_ns"]) + k * period_ns
                 for k in range(self.count)]
        ends = [rosbag.seconds(*rosbag.time_of(h)) + s
                for h, s in zip(heads, self.spans)]
        # the wheel odometry at each end stamp, from rest before the first
        odo = [np.eye(4)]
        for rel in self.drive["rel_odometry"][1:]:
            odo.append(odo[-1] @ rel)
        planar = [_planar(T) for T in odo]
        events = []   # (log time ns, order, topic, schema, payload)

        def tf_at(ns, x, y, yaw):
            sec, nsec = rosbag.time_of(ns)
            events.append((ns, 0, bag["tf_topic"], rosbag.TFMESSAGE,
                           rosbag.tf_message([(sec, nsec, odom, base,
                                               (x, y, 0.0),
                                               _yaw_quaternion(yaw))])))

        end_ns = [sec * 1_000_000_000 + nsec
                  for sec, nsec in map(rosbag.stamp_of, ends)]
        first = end_ns[0]
        standstill = int(round(float(bag["standstill_s"]) * 1e9))
        for ns in range(first - standstill, first, tf_ns):
            tf_at(ns, 0.0, 0.0, 0.0)
        tf_at(first, 0.0, 0.0, 0.0)
        for k in range(1, self.count):
            (x0, y0, a0), (x1, y1, a1) = planar[k - 1], planar[k]
            da = (a1 - a0 + math.pi) % (2 * math.pi) - math.pi
            steps = max(1, round((end_ns[k] - end_ns[k - 1]) / tf_ns))
            for j in range(1, steps):
                f = j / steps
                tf_at(end_ns[k - 1] + (end_ns[k] - end_ns[k - 1]) * j // steps,
                      x0 + f * (x1 - x0), y0 + f * (y1 - y0), a0 + f * da)
            tf_at(end_ns[k], x1, y1, a1)
        sec, nsec = rosbag.time_of(first - standstill)
        events.append((first - standstill, -1, bag["tf_static_topic"],
                       rosbag.TFMESSAGE, rosbag.tf_message([
                           (sec, nsec, base, bag["lidar_frame"],
                            bag["extrinsic_xyz_m"], (0.0, 0.0, 0.0, 1.0))])))
        for k in range(self.count):
            events.append((end_ns[k], 1, bag["lidar_topic"],
                           rosbag.POINTCLOUD2, k))
        events.sort(key=lambda ev: (ev[0], ev[1]))
        with rosbag.McapWriter(path, bag["compression"],
                               bag["chunk_bytes"]) as writer:
            for ns, _, topic, schema, payload in events:
                if topic == bag["lidar_topic"]:
                    sec, nsec = rosbag.time_of(heads[payload])
                    payload = rosbag.pointcloud2(
                        sec, nsec, bag["lidar_frame"], fields,
                        self._points(payload))
                writer.write(topic, schema, payload, ns)
        return ends, writer.bytes_out, writer.size

    # -- the program -------------------------------------------------------
    def prepare(self):
        t0 = time.perf_counter()
        self.prepare_inputs()
        self.timing = {"inputs_s": time.perf_counter() - t0}
        self.dir = tempfile.mkdtemp(prefix="icp_bench_bag_")
        bag_path = os.path.join(self.dir, "drive.mcap")
        self.ends, self.bag_bytes, self.bag_file_bytes = self.write_bag(
            bag_path)
        self.timing["bag_s"] = time.perf_counter() - t0
        params = self.config["bag"]["parameters"]
        config = self.config["config"]
        for k, v in params.items():
            if k in config and config[k] != v:
                raise ValueError(f"parameter {k}: the file's {v!r}, the "
                                 f"configuration's {config[k]!r}")
        self.argv = [bag_path, "--no-progress", "--device", str(self.device),
                     "--max-points", str(config["max_points"])]
        self.yaml = importlib.util.find_spec("yaml") is not None
        if self.yaml:
            path = os.path.join(self.dir, "kinematic_icp_ros.yaml")
            with open(path, "w") as f:
                f.write(yaml_text(params))
            self.argv += ["--config", path]
        from kinematic_icp_tpu_torch import run_odometry
        self.main = run_odometry.main
        self._pass("warm")
        self.timing["warm_pass_s"] = time.perf_counter() - t0
        self.passes = []

    def _pass(self, name):
        out = os.path.join(self.dir, f"pass_{name}")
        os.mkdir(out)
        timings = {}
        with contextlib.redirect_stdout(io.StringIO()):
            path = self.main(self.argv + ["--output-dir", out], timings)
        if "overflow" not in timings:
            raise RuntimeError("run_odometry.run gives no overflow total in "
                               "its timings")
        self.passes.append((path, timings))

    def measure(self, traced=None):
        t0 = time.perf_counter()
        i = 0
        while True:
            with driving.span(traced, SPAN_PASS, i):
                self._pass(i)
            i += 1
            if time.perf_counter() - t0 >= self.seconds:
                break
        return t0, time.perf_counter()

    def frames(self):
        return sum(t["frames"] for _, t in self.passes)

    def metrics(self, start, end):
        return {"frames_per_s": (self.frames() / (end - start), "frames/s")}

    def notes(self):
        per = {k: [round(t[k], 4) for _, t in self.passes]
               for k in ("read_s", "register_s", "write_s")}
        return {"frames": self.frames(), "passes": len(self.passes),
                "registered": [t["registered"] for _, t in self.passes],
                "bag_message_bytes": self.bag_bytes,
                "bag_file_bytes": self.bag_file_bytes,
                "parameter_file": self.yaml, **per, **self.timing}

    def answers(self):
        """Each pass's TUM file read back: its poses and its overflow."""
        return [(self.drive, read_tum(path)[1], int(timings["overflow"]))
                for path, timings in self.passes]

    def release(self):
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
