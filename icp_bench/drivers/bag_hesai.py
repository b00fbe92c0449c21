"""``bag_hesai``: the ``bag`` driver's recorded drive as a Hesai 128-channel
LiDAR's driver (HesaiLidar_ROS_2.0) records it: each point's ``timestamp``
is its absolute time in float64 seconds, and the header is stamped at the
scan's first firing.

Everything else is ``drivers/bag.py``'s ``Driver``, loaded by its path as
the harness loads drivers (a copy of its own, so that the field type added
here reaches only this driver's bags): the world, the scans, the /tf and
/tf_static messages, the passes through ``run_odometry.main`` and the
answers.  This file changes only what the layout changes:

* a ``float64`` field type;
* each point record's ``timestamp``: the header stamp plus the point's
  time from the first firing, in float64 seconds (near 1.7e9 s a float64
  steps by 238 ns);
* the end stamps, and so each scan's /tf sample: the header stamp plus the
  absolute stamps' max − min, where ``TimeStampHandler.cpp:115-128`` puts
  a begin-stamped scan's end when it reads the float64 field;
* the reference's per-point times: normalised from those same float64
  stamps (``:130-135``).

Traffic parameters: those of ``bag``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from icp_bench.core import rosbag


def _load_bag():
    path = Path(__file__).resolve().parent / "bag.py"
    spec = importlib.util.spec_from_file_location(
        "icp_bench_drivers_bag_for_hesai", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_bag = _load_bag()
#: sensor_msgs/PointField's FLOAT64
FLOAT64 = 8
_FIELD_TYPES = {**_bag._FIELD_TYPES, "float64": (FLOAT64, "<f8")}
_bag._FIELD_TYPES = _FIELD_TYPES
read_tum = _bag.read_tum
yaml_text = _bag.yaml_text


def normalised_stamps(stamps):
    """(end offset from the header stamp, normalised per-point times) of a
    begin-stamped scan's absolute float64 stamps: their max − min, and each
    stamp's share of it in float32 (TimeStampHandler.cpp:115-135)."""
    lo, hi = float(np.min(stamps)), float(np.max(stamps))
    return hi - lo, ((stamps - lo) / (hi - lo)).astype(np.float32)


class Driver(_bag.Driver):
    def prepare_inputs(self):
        super().prepare_inputs()
        bag = self.config["bag"]
        period_ns = int(round(1e9 / float(bag["scan_rate_hz"])))
        self.stamps, self.spans, frames = [], [], []
        for k, ((pts, _), times) in enumerate(zip(self.drive["frames"],
                                                  self.times)):
            head = rosbag.seconds(*rosbag.time_of(
                int(bag["start_ns"]) + k * period_ns))
            stamps = head + times.astype(np.float64)
            span, norm = normalised_stamps(stamps)
            self.stamps.append(stamps)
            self.spans.append(span)
            frames.append((pts, norm))
        self.drive["frames"] = frames

    def _points(self, k):
        """Scan ``k`` as HesaiLidar_ROS_2.0's point records."""
        bag, sensor = self.config["bag"], self.config["sensor"]
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
            1.0 - planar / float(sensor["max_range_m"]), 0.0, 1.0))
        rec["ring"] = self._ring(pts[:, 2] / np.maximum(planar, 1e-9))
        rec["timestamp"] = self.stamps[k]
        return rec
