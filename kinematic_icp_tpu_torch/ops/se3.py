"""Batched SE(3) / SO(3) operations on tensors.

Poses are (..., 4, 4) homogeneous matrices; twists are (..., 6) in Sophus
tangent order ``(v_x, v_y, v_z, w_x, w_y, w_z)``.  Every function is written
out elementwise with the JAX package's small-angle switch points, so float32
results stay finite and accurate where the naive forms cancel (``1 - cos t``
is exactly 0 in float32 below t ~ 3.4e-4).
"""

from __future__ import annotations

import torch

_SMALL = 1e-6


def _taylor_coeffs(theta):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (1-A)/t^2), float32-stable.

    B uses ``1 - cos t = 2 sin^2(t/2)``; C a Taylor branch below 0.5.
    """
    t2 = theta * theta
    small = theta < _SMALL
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                    torch.sin(safe_t) / safe_t)
    sh = torch.sin(0.5 * safe_t) / safe_t
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, 2.0 * sh * sh)
    C = torch.where(theta < 0.5,
                    1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (1.0 - A) / torch.where(theta < 0.5, 1.0, t2))
    return A, B, C


def _rodrigues(wx, wy, wz, A, B):
    """R = I + A W + B W^2 as 9 scalar planes (W^2 = w w^T - theta^2 I)."""
    t2 = wx * wx + wy * wy + wz * wz
    diag = 1.0 - B * t2
    r00 = diag + B * wx * wx
    r11 = diag + B * wy * wy
    r22 = diag + B * wz * wz
    r01 = B * wx * wy - A * wz
    r10 = B * wx * wy + A * wz
    r02 = B * wx * wz + A * wy
    r20 = B * wx * wz - A * wy
    r12 = B * wy * wz - A * wx
    r21 = B * wy * wz + A * wx
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    zero = torch.zeros_like(w[..., 0])
    return _mat([[zero, -w[..., 2], w[..., 1]],
                 [w[..., 2], zero, -w[..., 0]],
                 [-w[..., 1], w[..., 0], zero]])


def vee(W):
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _mat(rows):
    """Nested lists of same-shape planes -> (..., len(rows), len(row))."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def so3_exp(w):
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    theta = torch.sqrt(wx * wx + wy * wy + wz * wz)
    A, B, _ = _taylor_coeffs(theta)
    r = _rodrigues(wx, wy, wz, A, B)
    return _mat([r[0:3], r[3:6], r[6:9]])


def _quat_components(R):
    """(..., 3, 3) -> (qx, qy, qz, qw) planes by Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    sw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 2.0
    wq = (0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw)
    sx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    xq = ((m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx)
    sy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 2.0
    yq = ((m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy)
    sz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 2.0
    zq = ((m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz)

    # Largest pivot, ties broken in w, x, y, z order.
    use_w = (tr >= m00) & (tr >= m11) & (tr >= m22)
    use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
    use_y = ~use_w & ~use_x & (m11 >= m22)

    def sel(i):
        return torch.where(use_w, wq[i],
                           torch.where(use_x, xq[i],
                                       torch.where(use_y, yq[i], zq[i])))

    qw, qx, qy, qz = sel(0), sel(1), sel(2), sel(3)
    norm = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    return qx / norm, qy / norm, qz / norm, qw / norm


def _rotvec_components(R):
    """(..., 3, 3) -> (wx, wy, wz) planes of the rotation vector."""
    qx, qy, qz, qw = _quat_components(R)
    sign = torch.where(qw < 0, -1.0, 1.0)
    qx, qy, qz, qw = qx * sign, qy * sign, qz * sign, qw * sign
    n = torch.sqrt(qx * qx + qy * qy + qz * qz)
    small = n < _SMALL
    safe_n = torch.where(small, torch.ones_like(n), n)
    safe_w = torch.clamp(qw, min=_SMALL)
    theta_by_n = torch.where(
        small,
        2.0 / safe_w - 2.0 * n * n / (3.0 * safe_w ** 3),
        2.0 * torch.atan2(safe_n, qw) / safe_n,
    )
    return theta_by_n * qx, theta_by_n * qy, theta_by_n * qz


def so3_log(R):
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector."""
    return torch.stack(_rotvec_components(R), dim=-1)


def se3_exp(xi):
    """(..., 6) twist (v, w) -> (..., 4, 4); R = exp(w^), t = V v."""
    vx, vy, vz = xi[..., 0], xi[..., 1], xi[..., 2]
    wx, wy, wz = xi[..., 3], xi[..., 4], xi[..., 5]
    theta = torch.sqrt(wx * wx + wy * wy + wz * wz)
    A, B, C = _taylor_coeffs(theta)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rodrigues(wx, wy, wz, A, B)
    v00, v01, v02, v10, v11, v12, v20, v21, v22 = _rodrigues(wx, wy, wz, B, C)
    tx = v00 * vx + v01 * vy + v02 * vz
    ty = v10 * vx + v11 * vy + v12 * vz
    tz = v20 * vx + v21 * vy + v22 * vz
    one = torch.ones_like(tx)
    zero = torch.zeros_like(tx)
    return _mat([[r00, r01, r02, tx], [r10, r11, r12, ty],
                 [r20, r21, r22, tz], [zero, zero, zero, one]])


def se3_log(T):
    """(..., 4, 4) -> (..., 6) twist (v, w); inverse of ``se3_exp``."""
    tx, ty, tz = T[..., 0, 3], T[..., 1, 3], T[..., 2, 3]
    wx, wy, wz = _rotvec_components(T[..., :3, :3])
    t2 = wx * wx + wy * wy + wz * wz
    theta = torch.sqrt(t2)
    A, B, _ = _taylor_coeffs(theta)
    # (1 - A/(2B))/t^2 loses all significance in float32 below ~0.1; the
    # series is accurate to < 2e-7 relative at 0.5.
    small = theta < 0.5
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    coeff = torch.where(small,
                        1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                        (1.0 - A / (2.0 * B)) / safe_t2)
    # V^-1 = (1 - coeff theta^2) I - W/2 + coeff w w^T
    diag = 1.0 - coeff * t2
    i00 = diag + coeff * wx * wx
    i11 = diag + coeff * wy * wy
    i22 = diag + coeff * wz * wz
    i01 = coeff * wx * wy + 0.5 * wz
    i10 = coeff * wx * wy - 0.5 * wz
    i02 = coeff * wx * wz - 0.5 * wy
    i20 = coeff * wx * wz + 0.5 * wy
    i12 = coeff * wy * wz + 0.5 * wx
    i21 = coeff * wy * wz - 0.5 * wx
    vx = i00 * tx + i01 * ty + i02 * tz
    vy = i10 * tx + i11 * ty + i12 * tz
    vz = i20 * tx + i21 * ty + i22 * tz
    return torch.stack([vx, vy, vz, wx, wy, wz], dim=-1)


def inverse(T):
    """Explicit [R^T, -R^T t]."""
    tx, ty, tz = T[..., 0, 3], T[..., 1, 3], T[..., 2, 3]
    r00, r01, r02 = T[..., 0, 0], T[..., 0, 1], T[..., 0, 2]
    r10, r11, r12 = T[..., 1, 0], T[..., 1, 1], T[..., 1, 2]
    r20, r21, r22 = T[..., 2, 0], T[..., 2, 1], T[..., 2, 2]
    nx = -(r00 * tx + r10 * ty + r20 * tz)
    ny = -(r01 * tx + r11 * ty + r21 * tz)
    nz = -(r02 * tx + r12 * ty + r22 * tz)
    one = torch.ones_like(tx)
    zero = torch.zeros_like(tx)
    return _mat([[r00, r10, r20, nx], [r01, r11, r21, ny],
                 [r02, r12, r22, nz], [zero, zero, zero, one]])


def compose44(A, B):
    """Elementwise homogeneous compose A @ B of rigid transforms (same
    batch shape)."""
    a00, a01, a02, atx = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 0, 3]
    a10, a11, a12, aty = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2], A[..., 1, 3]
    a20, a21, a22, atz = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2], A[..., 2, 3]
    b00, b01, b02, btx = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2], B[..., 0, 3]
    b10, b11, b12, bty = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2], B[..., 1, 3]
    b20, b21, b22, btz = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2], B[..., 2, 3]
    one = torch.ones_like(atx)
    zero = torch.zeros_like(atx)
    return _mat([
        [a00 * b00 + a01 * b10 + a02 * b20,
         a00 * b01 + a01 * b11 + a02 * b21,
         a00 * b02 + a01 * b12 + a02 * b22,
         a00 * btx + a01 * bty + a02 * btz + atx],
        [a10 * b00 + a11 * b10 + a12 * b20,
         a10 * b01 + a11 * b11 + a12 * b21,
         a10 * b02 + a11 * b12 + a12 * b22,
         a10 * btx + a11 * bty + a12 * btz + aty],
        [a20 * b00 + a21 * b10 + a22 * b20,
         a20 * b01 + a21 * b11 + a22 * b21,
         a20 * b02 + a21 * b12 + a22 * b22,
         a20 * btx + a21 * bty + a22 * btz + atz],
        [zero, zero, zero, one]])


def rotation_angle(T):
    """|theta| of the rotation part."""
    trace = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def from_rt(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def identity(dtype=torch.float32, batch_shape=(), device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (4, 4))


def compose(A, B):
    return A @ B


def apply(T, points):
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def to_quaternion(T):
    """(..., 4, 4) -> (..., 4) quaternion (qx, qy, qz, qw), TUM order."""
    return torch.stack(_quat_components(T[..., :3, :3]), dim=-1)


def from_quaternion(q, t=None):
    """(qx, qy, qz, qw) [+ translation] -> (..., 4, 4)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = _mat([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
               2 * (x * z + y * w)],
              [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
               2 * (y * z - x * w)],
              [2 * (x * z - y * w), 2 * (y * z + x * w),
               1 - 2 * (x * x + y * y)]])
    if t is None:
        t = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    return from_rt(R, t)
