"""Per-point timestamp extraction and normalization.

Reimplements the reference ``TimeStampHandler``
(ros/src/kinematic_icp_ros/utils/TimeStampHandler.cpp):

  * the timestamp field is any of ``t``/``timestamp``/``time``/``stamps``
    (the LAST matching field wins, mirroring the C++ loop), in
    UINT32/FLOAT32/FLOAT64,
  * stamps whose integer part has more than 10 digits are nanoseconds and
    are rescaled (cpp:38-55),
  * begin- vs end-of-scan header stamping is detected by comparing the
    header stamp to the max point stamp; begin-stamped scans extend the end
    stamp by the scan duration (cpp:115-128),
  * per-point times are normalized to [0, 1] (cpp:130-135),
  * a missing field yields empty timestamps => deskew disabled (cpp:51-54).

``decode_scan`` gives a cloud's points, stamps and normalized per-point
times in one ``Scan``; while recording (``utils.profiling``) its time
field's extraction, digit rule and normalization run in a
``kicp.stamps`` span.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import profiling
from .messages import PointCloud2, PointFieldType

_CANDIDATE_FIELDS = ("t", "timestamp", "time", "stamps")
_SUPPORTED = (PointFieldType.UINT32, PointFieldType.FLOAT32,
              PointFieldType.FLOAT64)


def extract_timestamps(msg: PointCloud2) -> np.ndarray | None:
    """Raw per-point stamps in seconds, or None if no usable field."""
    field = None
    for f in msg.fields:
        if f.name in _CANDIDATE_FIELDS and f.count:
            field = f  # last match wins (TimeStampHandler.cpp:22-28)
    if field is None:
        return None
    if field.datatype not in _SUPPORTED:
        raise ValueError(
            f"timestamp field type {field.datatype} not supported")
    stamps = msg.field_array(field.name).astype(np.float64)
    # nanosecond auto-detection by digit count (cpp:38-55)
    seconds = np.round(stamps)
    digits = np.where(seconds > 0, np.floor(np.log10(
        np.maximum(seconds, 1.0)) + 1.0), 1.0)
    return np.where(digits > 10, stamps * 1e-9, stamps)


class Scan(NamedTuple):
    """A decoded scan: what the server registers of a PointCloud2."""
    points: np.ndarray              # (N, 3) float32, the sensor's frame
    stamp: float                    # the header stamp, seconds
    end: float                      # the scan's end stamp (cpp:115-128)
    timestamps: np.ndarray | None   # per-point, normalized to [0, 1]
    frame_id: str


def decode_scan(msg: PointCloud2) -> Scan:
    """The points, stamps and normalized per-point times of a cloud
    (cpp:115-135)."""
    stamp = msg.header.stamp.to_sec()
    end = stamp
    normalized = None
    with profiling.span("kicp.stamps"):
        stamps = extract_timestamps(msg)
        if stamps is not None and len(stamps):
            mx = float(np.max(stamps))
            mn = float(np.min(stamps))
            if abs(stamp - mx) > 1e-8:
                # begin-stamped scan: extend by the scan duration
                end = stamp + (mx - mn)
            if mx > mn:
                normalized = ((stamps - mn) / (mx - mn)).astype(np.float32)
            # mx == mn: degenerate stamps; deskew would be a no-op — treat
            # as missing (the C++ would divide by zero here)
    return Scan(msg.xyz(), stamp, end, normalized, msg.header.frame_id)


class TimeStampHandler:
    def __init__(self):
        self.last_processed_stamp: float = 0.0

    def process_timestamps(self, msg: PointCloud2):
        """Returns (begin_stamp, end_stamp, normalized_ts or None).

        Mirrors TimeStampHandler::ProcessTimestamps (cpp:108-139): the
        begin stamp for odometry queries is the previous scan's end stamp.
        """
        begin_stamp = self.last_processed_stamp
        scan = decode_scan(msg)
        self.last_processed_stamp = scan.end
        return begin_stamp, scan.end, scan.timestamps
