"""TUM trajectory file I/O.

Write format matches the reference offline node exactly: one line per pose,
``stamp x y z qx qy qz qw`` at 6-decimal fixed precision
(ros/src/kinematic_icp_ros/nodes/offline_node.cpp:76-97).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def write_tum(path, stamped_poses):
    """stamped_poses: iterable of (timestamp_sec, (4, 4) pose)."""
    with open(path, "w") as f:
        for stamp, pose in stamped_poses:
            pose = np.asarray(pose, np.float64)
            t = pose[:3, 3]
            q = Rotation.from_matrix(pose[:3, :3]).as_quat()  # (x, y, z, w)
            f.write(f"{stamp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum(path):
    """Returns (stamps (N,), poses list of (4, 4))."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) != 8:
                raise ValueError(f"bad TUM line: {line!r}")
            stamp, x, y, z, qx, qy, qz, qw = vals
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
            T[:3, 3] = [x, y, z]
            stamps.append(stamp)
            poses.append(T)
    return np.asarray(stamps), poses
