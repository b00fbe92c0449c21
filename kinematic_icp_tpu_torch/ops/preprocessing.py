"""Scan preprocessing: motion deskew + range filtering (planar form).

Equivalent of ``kiss_icp::Preprocessor`` (KISS-ICP v1.2.0).  Each point is
mapped by ``exp((tau - 1) * xi)`` with ``xi = log(relative_motion)``; since
every per-point twist is a scalar multiple of one twist, the exponential
reduces to a fixed-axis Rodrigues rotation plus a V-matrix translation
against per-point sin/cos.
"""

from __future__ import annotations

import torch

from . import se3
from .points import P3, per_row

_SMALL = 1e-6


def _cross(ax, ay, az, b: P3) -> P3:
    """(fixed vector a) x (planar points b)."""
    return P3(ay * b.z - az * b.y, az * b.x - ax * b.z, ax * b.y - ay * b.x)


def deskew(p: P3, timestamps, relative_motion, enable) -> P3:
    """Constant-velocity motion compensation, anchored at scan end.
    Batched: (B, N) planes and stamps, (B, 4, 4) motion, (B,) enable."""
    return deskew_from_twist(p, timestamps, se3.se3_log(relative_motion),
                             enable)


def deskew_from_twist(p: P3, timestamps, xi, enable) -> P3:
    """``deskew`` given the precomputed twist ``xi = log(relative_motion)``.

    With theta = |w|, axis k = w/theta and the signed per-point angle
    a_i = s_i theta (s_i = tau_i - 1):

      R(a_i) p = p cos a_i + (k x p) sin a_i + k (k . p)(1 - cos a_i)
      t_i      = s_i [v + ((1-cos a_i)/a_i)(k x v) + ((a_i - sin a_i)/a_i)(k x (k x v))]
    """
    w = xi[..., 3:]
    theta = torch.sqrt(torch.sum(w * w, dim=-1))
    rot_small = theta < _SMALL
    safe_theta = torch.where(rot_small, 1.0, theta)
    kx_, ky_, kz_ = (per_row(w[..., i] / safe_theta) for i in range(3))
    v = [per_row(xi[..., i]) for i in range(3)]
    theta, rot_small = per_row(theta), per_row(rot_small)

    s = torch.where(per_row(enable), timestamps - 1.0,
                    torch.zeros_like(timestamps))
    a = s * theta
    sin_a = torch.sin(a)
    cos_a = torch.cos(a)
    one_m_cos = 1.0 - cos_a

    # rotation: fixed-axis Rodrigues
    kxp = _cross(kx_, ky_, kz_, p)
    k_dot_p = kx_ * p.x + ky_ * p.y + kz_ * p.z
    rx = p.x * cos_a + kxp.x * sin_a + kx_ * k_dot_p * one_m_cos
    ry = p.y * cos_a + kxp.y * sin_a + ky_ * k_dot_p * one_m_cos
    rz = p.z * cos_a + kxp.z * sin_a + kz_ * k_dot_p * one_m_cos
    rx = torch.where(rot_small, p.x, rx)
    ry = torch.where(rot_small, p.y, ry)
    rz = torch.where(rot_small, p.z, rz)

    # translation: V(a k)(s v), with the cancellation-free
    # (1-cos a)/a = 2 sin^2(a/2)/a and a Taylor branch of (a - sin a)/a
    a2 = a * a
    small_a = torch.abs(a) < _SMALL
    safe_a = torch.where(small_a, 1.0, a)
    sin_ha = torch.sin(0.5 * a)
    c1 = torch.where(small_a, a * 0.5, 2.0 * sin_ha * sin_ha / safe_a)
    c2 = torch.where(torch.abs(a) < 0.1,
                     (a2 / 6.0) * (1.0 - a2 / 20.0),
                     (a - sin_a) / safe_a)
    kxv = (ky_ * v[2] - kz_ * v[1],
           kz_ * v[0] - kx_ * v[2],
           kx_ * v[1] - ky_ * v[0])
    kxkxv = (ky_ * kxv[2] - kz_ * kxv[1],
             kz_ * kxv[0] - kx_ * kxv[2],
             kx_ * kxv[1] - ky_ * kxv[0])
    tx = s * v[0] + s * (c1 * kxv[0] + c2 * kxkxv[0])
    ty = s * v[1] + s * (c1 * kxv[1] + c2 * kxkxv[1])
    tz = s * v[2] + s * (c1 * kxv[2] + c2 * kxkxv[2])
    tx = torch.where(rot_small, s * v[0], tx)
    ty = torch.where(rot_small, s * v[1], ty)
    tz = torch.where(rot_small, s * v[2], tz)

    return P3(rx + tx, ry + ty, rz + tz)


def range_filter_mask(p: P3, mask, min_range: float, max_range: float):
    """Keep ``min_range < |p| < max_range`` (strict; NaN points fail both
    comparisons and drop)."""
    r2 = p.x * p.x + p.y * p.y + p.z * p.z
    keep = (r2 < max_range * max_range) & (r2 > min_range * min_range)
    return mask & keep


def preprocess(p: P3, timestamps, mask, relative_motion_in_lidar, *,
               min_range: float, max_range: float, deskew_enabled,
               has_timestamps, twist=None):
    """Deskew, then range-filter the deskewed points (KISS-ICP v1.2.0
    order).  ``twist``: optional precomputed
    ``se3_log(relative_motion_in_lidar)``."""
    enable = has_timestamps & deskew_enabled
    if twist is not None:
        out = deskew_from_twist(p, timestamps, twist, enable)
    else:
        out = deskew(p, timestamps, relative_motion_in_lidar, enable)
    return out, range_filter_mask(out, mask, min_range, max_range)
