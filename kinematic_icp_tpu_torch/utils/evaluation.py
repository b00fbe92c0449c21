"""Trajectory evaluation: ATE / RPE metrics (TUM-style).

Absolute trajectory error with optional SE(3) Umeyama alignment, and
relative pose error over a fixed frame delta (numpy).
"""

from __future__ import annotations

import numpy as np


def _positions(poses):
    return np.asarray([np.asarray(p, np.float64)[:3, 3] for p in poses])


def umeyama_alignment(src, dst, with_scale=False):
    """Least-squares rigid alignment src -> dst (Umeyama 1991).

    Returns (R, t, s) minimizing ||dst - (s R src + t)||^2.
    """
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    if with_scale:
        var = (xs * xs).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(gt_poses, est_poses, align=True):
    """Absolute trajectory error RMSE over translations.

    Args:
      gt_poses / est_poses: sequences of (4, 4) poses (same length & order).
      align: SE(3)-align estimate to ground truth first (standard ATE).
    """
    gt = _positions(gt_poses)
    est = _positions(est_poses)
    assert gt.shape == est.shape and len(gt) > 0
    if align and len(gt) >= 3:
        R, t, _ = umeyama_alignment(est, gt)
        est = est @ R.T + t
    err = gt - est
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def rpe(gt_poses, est_poses, delta=1):
    """Relative pose error over a frame delta.

    Returns (trans_rmse, rot_rmse_rad).
    """
    gt = [np.asarray(p, np.float64) for p in gt_poses]
    est = [np.asarray(p, np.float64) for p in est_poses]
    terr, rerr = [], []
    for i in range(len(gt) - delta):
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        de = np.linalg.inv(est[i]) @ est[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(np.arccos(c))
    return (float(np.sqrt(np.mean(np.square(terr)))),
            float(np.sqrt(np.mean(np.square(rerr)))))
