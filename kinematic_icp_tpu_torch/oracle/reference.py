"""Float64 numpy SE(3) helpers for host-side math.

The server's stationary gate (``|log(delta)| > 1e-3``,
LidarOdometryServer.cpp:202) and its published twist
(``log(last^-1 new) / dt``, cpp:210-214) run on the host in float64 with
these, the same code as the JAX package's oracle, so both packages gate and
publish alike bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial.transform import Rotation


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
