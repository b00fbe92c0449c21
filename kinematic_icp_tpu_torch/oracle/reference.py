"""Reference-faithful CPU oracle of the Kinematic-ICP algorithm.

A direct float64 numpy re-expression of the reference algorithm
(cpp/kinematic_icp: pipeline/KinematicICP.cpp, registration/
Registration.cpp, correspondence_threshold/CorrespondenceThreshold.cpp)
and the KISS-ICP v1.2.0 internals it uses (Preprocessor, VoxelDownsample,
VoxelHashMap).  Dynamically sized Python containers mirror the C++
std::vector/robin_map behavior, including first-come-kept voxel blocks and
per-iteration re-association.

Purpose: differential testing of the PyTorch/CUDA pipeline, which shares
no code with it.  This module intentionally mirrors the *reference*
control flow, not the device design.  The server's stationary gate
(``|log(delta)| > 1e-3``, LidarOdometryServer.cpp:202) and its published
twist (``log(last^-1 new) / dt``, cpp:210-214) also run on the host with
``se3_log``/``se3_exp``, so the port and the JAX package gate and publish
alike bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.spatial.transform import Rotation

from ..config import Config

_EPS_TINY = np.finfo(np.float64).tiny


# ----------------------------------------------------------------------
# Minimal SE(3) helpers (numpy float64)
# ----------------------------------------------------------------------

def se3_exp(xi):
    v, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        R = np.eye(3) + W + 0.5 * (W @ W)
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        A = math.sin(th) / th
        B = (1.0 - math.cos(th)) / th**2
        C = (1.0 - A) / th**2
        R = np.eye(3) + A * W + B * (W @ W)
        V = np.eye(3) + B * W + C * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def se3_log(T):
    R = T[:3, :3]
    t = T[:3, 3]
    w = Rotation.from_matrix(R).as_rotvec()
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        Vinv = np.eye(3) - 0.5 * W + (W @ W) / 12.0
    else:
        A = math.sin(th) / th
        B = (1.0 - math.cos(th)) / th**2
        Vinv = np.eye(3) - 0.5 * W + (1.0 - A / (2.0 * B)) / th**2 * (W @ W)
    return np.concatenate([Vinv @ t, w])


# ----------------------------------------------------------------------
# KISS-ICP v1.2.0 building blocks
# ----------------------------------------------------------------------

def voxel_downsample(points, voxel_size):
    """First point per voxel, insertion order (robin_map analog)."""
    grid = {}
    for p in points:
        key = (int(math.floor(p[0] / voxel_size)),
               int(math.floor(p[1] / voxel_size)),
               int(math.floor(p[2] / voxel_size)))
        if key not in grid:
            grid[key] = p
    if not grid:
        return np.zeros((0, 3))
    return np.array(list(grid.values()))


def preprocess(points, timestamps, relative_motion, *, deskew, min_range,
               max_range):
    """Preprocessor::Preprocess: deskew (scan-end anchor) then range filter."""
    pts = np.asarray(points, np.float64)
    if deskew and timestamps is not None and len(timestamps) == len(pts):
        omega = se3_log(relative_motion)
        out = np.empty_like(pts)
        for i, (p, tau) in enumerate(zip(pts, timestamps)):
            M = se3_exp((tau - 1.0) * omega)
            out[i] = M[:3, :3] @ p + M[:3, 3]
        pts = out
    r = np.linalg.norm(pts, axis=1)
    keep = (r < max_range) & (r > min_range)
    return pts[keep]


class VoxelHashMap:
    """robin_map<Voxel, VoxelBlock> analog with KISS-ICP v1.2.0 semantics."""

    def __init__(self, voxel_size, max_distance, max_points_per_voxel):
        self.voxel_size = voxel_size
        self.max_distance = max_distance
        self.max_points_per_voxel = max_points_per_voxel
        self.grid: dict[tuple, list] = {}

    def empty(self):
        return not self.grid

    def clear(self):
        self.grid.clear()

    def _key(self, p):
        vs = self.voxel_size
        return (int(math.floor(p[0] / vs)), int(math.floor(p[1] / vs)),
                int(math.floor(p[2] / vs)))

    def add_points(self, points):
        for p in points:
            block = self.grid.setdefault(self._key(p), [])
            if len(block) < self.max_points_per_voxel:
                block.append(np.asarray(p, np.float64))

    def remove_far(self, origin):
        md2 = self.max_distance**2
        dead = [k for k, b in self.grid.items()
                if np.sum((b[0] - origin) ** 2) > md2]
        for k in dead:
            del self.grid[k]

    def update(self, points, pose):
        world = points @ pose[:3, :3].T + pose[:3, 3]
        self.add_points(world)
        self.remove_far(pose[:3, 3])

    def get_closest_neighbor(self, p):
        kx, ky, kz = self._key(p)
        best, best_d = None, np.inf
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for q in self.grid.get((kx + dx, ky + dy, kz + dz), ()):
                        d = np.linalg.norm(q - p)
                        if d < best_d:
                            best, best_d = q, d
        return best, best_d

    def pointcloud(self):
        if not self.grid:
            return np.zeros((0, 3))
        return np.concatenate([np.array(b) for b in self.grid.values()])


# ----------------------------------------------------------------------
# Kinematic registration (Registration.cpp)
# ----------------------------------------------------------------------

def motion_model(controls):
    rho, theta = controls
    dx = np.zeros(6)
    dx[0] = rho * math.sin(theta) / (theta + _EPS_TINY)
    dx[1] = rho * (1.0 - math.cos(theta)) / (theta + _EPS_TINY)
    dx[5] = theta
    return se3_exp(dx)


def data_association(points, voxel_map, T, tau):
    src, tgt = [], []
    Rm, t = T[:3, :3], T[:3, 3]
    for p in points:
        q, d = voxel_map.get_closest_neighbor(Rm @ p + t)
        if d < tau:
            src.append(p)
            tgt.append(q)
    return (np.array(src).reshape(-1, 3), np.array(tgt).reshape(-1, 3))


def compute_odometry_regularization(src, tgt, guess):
    if len(src) == 0:
        return 0.0
    res = src @ guess[:3, :3].T + guess[:3, 3] - tgt
    mean_sq = float(np.mean(np.sum(res * res, axis=1)))
    return 1.0 / (mean_sq + _EPS_TINY)


def compute_perturbation(src, tgt, T, beta):
    n = len(src)
    if n == 0:
        return np.zeros(2)
    R = T[:3, :3]
    res = src @ R.T + T[:3, 3] - tgt            # (N, 3)
    j0 = R[:, 0]                                 # (3,)
    j1 = (-src[:, 1:2]) * R[:, 0] + src[:, 0:1] * R[:, 1]  # (N, 3)
    JTJ = np.array([
        [n * float(j0 @ j0), float(np.sum(j1 @ j0))],
        [float(np.sum(j1 @ j0)), float(np.sum(j1 * j1))],
    ])
    JTr = np.array([float(np.sum(res @ j0)), float(np.sum(j1 * res))])
    JTJ /= n
    JTr /= n
    JTJ[0, 0] += beta
    return -np.linalg.solve(JTJ, JTr)


def compute_robot_motion(points, voxel_map, last_pose, relative_odometry,
                         tau, cfg: Config):
    current = last_pose @ relative_odometry
    if voxel_map.empty():
        return current
    src, tgt = data_association(points, voxel_map, current, tau)
    if cfg.use_adaptive_odometry_regularization:
        beta = compute_odometry_regularization(src, tgt, current)
    else:
        beta = cfg.fixed_regularization
    for _ in range(cfg.max_num_iterations):
        dx = compute_perturbation(src, tgt, current, beta)
        current = current @ motion_model(dx)
        if np.linalg.norm(dx) < cfg.convergence_criterion:
            break
        src, tgt = data_association(points, voxel_map, current, tau)
    return current


# ----------------------------------------------------------------------
# Pipeline (KinematicICP.cpp) + threshold
# ----------------------------------------------------------------------

@dataclasses.dataclass
class OracleKinematicICP:
    """Stateful oracle mirroring kinematic_icp::pipeline::KinematicICP."""

    config: Config

    def __post_init__(self):
        cfg = self.config
        self.last_pose = np.eye(4)
        self.local_map = VoxelHashMap(cfg.voxel_size, cfg.max_range,
                                      cfg.max_points_per_voxel)
        self.odom_sse = 0.0
        self.num_samples = 1e-8

    # CorrespondenceThreshold
    def compute_threshold(self):
        cfg = self.config
        if not cfg.use_adaptive_threshold:
            return cfg.fixed_threshold
        sigma_odom = math.sqrt(self.odom_sse / self.num_samples)
        return 3.0 * (cfg.map_resolution() + sigma_odom)

    def update_odometry_error(self, err):
        if not self.config.use_adaptive_threshold:
            return
        theta = np.linalg.norm(Rotation.from_matrix(err[:3, :3]).as_rotvec())
        e = (np.linalg.norm(err[:3, 3])
             + 2.0 * self.config.max_range * math.sin(theta / 2.0))
        self.odom_sse += e * e
        self.num_samples += 1.0

    def set_pose(self, pose):
        self.last_pose = np.asarray(pose, np.float64)
        self.local_map.clear()
        self.odom_sse = 0.0
        self.num_samples = 1e-8

    def register_frame(self, frame, timestamps, lidar_to_base,
                       relative_odometry):
        """KinematicICP::RegisterFrame (cpp:48-85)."""
        cfg = self.config
        ext = np.asarray(lidar_to_base, np.float64)
        rel = np.asarray(relative_odometry, np.float64)
        rel_in_lidar = np.linalg.inv(ext) @ rel @ ext
        pre = preprocess(frame, timestamps, rel_in_lidar, deskew=cfg.deskew,
                         min_range=cfg.min_range, max_range=cfg.max_range)
        pre_base = pre @ ext[:3, :3].T + ext[:3, 3]
        frame_downsample = voxel_downsample(pre_base, cfg.voxel_size * 0.5)
        source = voxel_downsample(frame_downsample, cfg.voxel_size * 1.5)
        tau = self.compute_threshold()
        new_pose = compute_robot_motion(source, self.local_map, self.last_pose,
                                        rel, tau, cfg)
        odometry_error = np.linalg.inv(self.last_pose @ rel) @ new_pose
        self.update_odometry_error(odometry_error)
        self.local_map.update(frame_downsample, new_pose)
        self.last_pose = new_pose
        return pre_base, source
