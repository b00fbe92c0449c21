"""Transform tree buffer with time interpolation (tf2-free).

Reimplements the tf2 functionality the reference depends on
(ros/include/kinematic_icp_ros/utils/RosUtils.hpp:101-130): a buffer of
stamped parent->child transforms forming a tree, ``lookup_transform`` walking
the tree with per-edge linear interpolation (slerp for rotation — tf2's
behavior), and the *time-travel* ``lookup_delta_transform`` used to obtain
the wheel-odometry increment between two scan stamps via a fixed frame.
Lookup failures return identity with a warning, matching the reference's
degraded behavior (RosUtils.hpp:109-112,126-129).
"""

from __future__ import annotations

import bisect
import logging

import numpy as np
from scipy.spatial.transform import Rotation, Slerp

log = logging.getLogger("kinematic_icp_tpu_torch.tf")


class TransformBuffer:
    def __init__(self, cache_time: float = 1e18):
        # edges[(parent, child)] = (stamps list, translations, rotations)
        self._edges: dict[tuple, list] = {}
        self._static: dict[tuple, np.ndarray] = {}
        self._parent_of: dict[str, str] = {}
        self.cache_time = cache_time

    # ------------------------------------------------------------------
    def set_transform(self, parent: str, child: str, T, stamp: float,
                      is_static: bool = False):
        T = np.asarray(T, np.float64)
        self._parent_of[child] = parent
        if is_static:
            self._static[(parent, child)] = T
            return
        key = (parent, child)
        entry = self._edges.setdefault(key, ([], [], []))
        stamps, ts, qs = entry
        q = Rotation.from_matrix(T[:3, :3]).as_quat()
        i = bisect.bisect(stamps, stamp)
        stamps.insert(i, stamp)
        ts.insert(i, T[:3, 3].copy())
        qs.insert(i, q)
        # drop entries beyond cache_time
        while stamps and stamps[-1] - stamps[0] > self.cache_time:
            stamps.pop(0)
            ts.pop(0)
            qs.pop(0)

    def add_transform_stamped(self, msg, is_static: bool = False):
        self.set_transform(msg.header.frame_id, msg.child_frame_id,
                           msg.matrix(), msg.header.stamp.to_sec(), is_static)

    def frame_exists(self, frame: str) -> bool:
        return (frame in self._parent_of
                or any(p == frame for p in self._parent_of.values()))

    # ------------------------------------------------------------------
    def _edge_transform(self, parent: str, child: str, stamp: float | None):
        key = (parent, child)
        if key in self._static:
            return self._static[key]
        entry = self._edges.get(key)
        if entry is None or not entry[0]:
            raise KeyError(f"no transform {parent} -> {child}")
        stamps, ts, qs = entry
        if stamp is None or len(stamps) == 1:
            i = len(stamps) - 1
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat(qs[i]).as_matrix()
            T[:3, 3] = ts[i]
            return T
        # clamp + interpolate
        if stamp <= stamps[0]:
            i0 = i1 = 0
        elif stamp >= stamps[-1]:
            i0 = i1 = len(stamps) - 1
        else:
            i1 = bisect.bisect(stamps, stamp)
            i0 = i1 - 1
        T = np.eye(4)
        if i0 == i1:
            T[:3, :3] = Rotation.from_quat(qs[i0]).as_matrix()
            T[:3, 3] = ts[i0]
        else:
            a = (stamp - stamps[i0]) / (stamps[i1] - stamps[i0])
            rot = Slerp([0.0, 1.0],
                        Rotation.from_quat([qs[i0], qs[i1]]))(a)
            T[:3, :3] = rot.as_matrix()
            T[:3, 3] = (1 - a) * np.asarray(ts[i0]) + a * np.asarray(ts[i1])
        return T

    def _chain_to_root(self, frame: str):
        chain = [frame]
        while chain[-1] in self._parent_of:
            chain.append(self._parent_of[chain[-1]])
        return chain

    def lookup_transform(self, target: str, source: str,
                         stamp: float | None = None) -> np.ndarray:
        """T_target_source (pose of source expressed in target).

        Walks up the tree from both frames to their common ancestor with
        interpolation at ``stamp`` (None = latest).  Returns identity with
        a warning on failure (RosUtils.hpp:109-112).
        """
        try:
            return self._lookup(target, source, stamp)
        except KeyError as e:
            log.warning("tf lookup failed (%s); using identity", e)
            return np.eye(4)

    def _lookup(self, target: str, source: str, stamp):
        if target == source:
            return np.eye(4)
        up_t = self._chain_to_root(target)
        up_s = self._chain_to_root(source)
        common = None
        for f in up_s:
            if f in up_t:
                common = f
                break
        if common is None:
            raise KeyError(f"frames {target} and {source} are disconnected")
        # T_common_source
        T_cs = np.eye(4)
        f = source
        while f != common:
            p = self._parent_of[f]
            T_cs = self._edge_transform(p, f, stamp) @ T_cs
            f = p
        # T_common_target
        T_ct = np.eye(4)
        f = target
        while f != common:
            p = self._parent_of[f]
            T_ct = self._edge_transform(p, f, stamp) @ T_ct
            f = p
        return np.linalg.inv(T_ct) @ T_cs

    def lookup_delta_transform(self, base_frame: str, stamp_begin: float,
                               stamp_end: float, fixed_frame: str) -> np.ndarray:
        """Wheel-odometry delta: base@begin -> base@end via the fixed frame.

        tf2 time-travel lookup (RosUtils.hpp:115-130):
        ``X(t)= T_fixed_base(t)``; delta = X(begin)^-1 X(end).
        """
        try:
            X0 = self._lookup(fixed_frame, base_frame, stamp_begin)
            X1 = self._lookup(fixed_frame, base_frame, stamp_end)
            return np.linalg.inv(X0) @ X1
        except KeyError as e:
            log.warning("tf delta lookup failed (%s); using identity", e)
            return np.eye(4)
