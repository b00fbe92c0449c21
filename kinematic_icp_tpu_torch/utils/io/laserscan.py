"""LaserScan -> PointCloud2 projection (laser_geometry-free).

Reimplements the 2D ingestion path of the reference OnlineNode
(ros/src/kinematic_icp_ros/nodes/online_node.cpp:45-58): project each valid
range to planar xyz and attach a per-beam timestamp channel
(``laser_geometry::channel_option::Timestamp`` semantics: beam i fires at
``i * time_increment`` after the scan start).
"""

from __future__ import annotations

import numpy as np

from .messages import LaserScan, PointCloud2, PointFieldType


def project_laser(scan: LaserScan) -> PointCloud2:
    """Valid-range beams -> planar cloud with a FLOAT32 ``stamps`` field
    (numpy projection)."""
    n = len(scan.ranges)
    angles = scan.angle_min + np.arange(n) * scan.angle_increment
    r = np.asarray(scan.ranges, np.float64)
    valid = np.isfinite(r) & (r >= scan.range_min) & (r <= scan.range_max)
    xs = (r * np.cos(angles))[valid].astype(np.float32)
    ys = (r * np.sin(angles))[valid].astype(np.float32)
    zs = np.zeros_like(xs)
    stamps = (np.arange(n) * scan.time_increment)[valid].astype(np.float32)
    pts = np.stack([xs, ys, zs], axis=-1)
    return PointCloud2.from_xyz(
        pts, stamp=scan.header.stamp.to_sec(),
        frame_id=scan.header.frame_id, timestamps=stamps,
        timestamp_field="stamps", timestamp_type=PointFieldType.FLOAT32)
