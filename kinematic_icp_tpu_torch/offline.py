"""Offline processing of a whole sequence (the reference OfflineNode loop).

All frames are padded into device tensors once; the per-frame recurrence
(pose, map, threshold) then advances in a Python loop over frames whose
steps read nothing back to the host, and the stationary gate runs on the
device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import Config
from .models import pipeline
from .ops import se3
from .runtime import resolve_device


def _per_frame_constants(rels, extrinsic, config: Config):
    """Pose-independent per-frame values, vectorized over all frames.

    Returns (active (F,), twists (F, 6) or None): the stationary-gate flag
    (LidarOdometryServer.cpp:202) and the deskew twist
    ``log(ext^-1 rel ext)`` (KinematicICP.cpp:53-55).
    """
    active = torch.linalg.vector_norm(se3.se3_log(rels), dim=-1) > 1e-3
    twists = None
    if config.deskew:
        f = rels.shape[0]
        ext = extrinsic.expand(f, 4, 4)
        conj = se3.compose44(se3.compose44(se3.inverse(ext), rels), ext)
        twists = se3.se3_log(conj)
    return active, twists


def make_sequence_runner(config: Config, device=None):
    """Build the sequence runner: ``run(state, pts, ts, mask, has_ts,
    extrinsic, rels) -> (final_state, poses (F, 4, 4), overflow (3,),
    fallbacks ())``.

    ``overflow`` totals [downsample drops, source drops, insert failures]
    over the sequence; ``fallbacks`` (int32) counts the active frames on
    which an exact mode's certificate failed and the full-27 loop
    recomputed the solve.  ``device`` (``None`` = CUDA; raises if absent)
    is where the inputs must live.
    """
    dev = resolve_device(device)

    def run(state, pts, ts, mask, has_ts, extrinsic, rels):
        for t in (pts, ts, mask, has_ts, extrinsic, rels, state.pose):
            if t.device.type != dev.type:
                raise ValueError(f"sequence runner on {dev}: got a tensor "
                                 f"on {t.device}")
        active, twists = _per_frame_constants(rels, extrinsic, config)
        poses = []
        overflow = torch.zeros(3, dtype=torch.int32, device=dev)
        fallbacks = torch.zeros((), dtype=torch.int32, device=dev)
        for f in range(pts.shape[0]):
            state, out = pipeline.register_frame(
                state, pts[f], ts[f], mask[f], has_ts[f], extrinsic, rels[f],
                config, active=active[f],
                rel_twist_in_lidar=None if twists is None else twists[f])
            poses.append(state.pose)
            overflow = overflow + out.overflow
            if out.debug.exact_fallback is not None:
                fallbacks = fallbacks + (out.debug.exact_fallback
                                         & active[f]).to(torch.int32)
        return state, torch.stack(poses), overflow, fallbacks

    return run


def pad_sequence(frames, rel_odometry, config: Config, timestamps=None):
    """Pack ragged frames into (F, N, ...) numpy arrays.

    frames: list of (points (N_i, 3), ts (N_i,)) tuples or plain arrays.
    Scans longer than ``config.max_points`` are truncated, which removes an
    angular sector of a spinning lidar and degrades registration, so it
    warns with the total.
    """
    f = len(frames)
    n = config.max_points
    pts = np.zeros((f, n, 3), np.float32)
    ts = np.zeros((f, n), np.float32)
    mask = np.zeros((f, n), bool)
    has_ts = np.zeros((f,), bool)
    rels = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    truncated_points = 0
    truncated_frames = 0
    for i, fr in enumerate(frames):
        if isinstance(fr, tuple):
            p, t = fr
        else:
            p, t = fr, None
        if timestamps is not None:
            t = timestamps[i]
        p = np.asarray(p, np.float32).reshape(-1, 3)
        k = min(len(p), n)
        if len(p) > n:
            truncated_points += len(p) - n
            truncated_frames += 1
        pts[i, :k] = p[:k]
        mask[i, :k] = True
        if t is not None and len(t) >= k:
            ts[i, :k] = np.asarray(t, np.float32)[:k]
            has_ts[i] = True
        if rel_odometry is not None and rel_odometry[i] is not None:
            rels[i] = np.asarray(rel_odometry[i], np.float32)
    if truncated_points:
        warnings.warn(
            f"pad_sequence dropped {truncated_points} points from "
            f"{truncated_frames}/{f} scans longer than Config.max_points="
            f"{n}; scan-tail truncation removes an angular sector and "
            f"degrades accuracy — raise max_points", stacklevel=2)
    return pts, ts, mask, has_ts, rels


def run_offline(frames, rel_odometry, config: Config | None = None,
                extrinsic=None, initial_pose=None, timestamps=None,
                state=None, device=None, return_stats=False):
    """Process a full sequence; returns (poses (F, 4, 4) np, final_state),
    and with ``return_stats`` a third item, ``{"overflow": (3,) np int32,
    "exact_fallback_frames": int}`` (see ``make_sequence_runner``).

    ``device`` ``None`` means CUDA (raises if absent); pass ``"cpu"`` to run
    on the CPU.  Warns when a static capacity overflowed.
    """
    dev = resolve_device(device)
    config = config or Config()
    arrays = pad_sequence(frames, rel_odometry, config, timestamps)
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a).to(dev)
                                   for a in arrays)
    if state is None:
        state = pipeline.init_state(config, initial_pose=initial_pose,
                                    device=dev)
    ext = torch.eye(4, dtype=torch.float32) if extrinsic is None else \
        torch.as_tensor(np.asarray(extrinsic, np.float32))
    runner = make_sequence_runner(config, dev)
    final_state, poses, overflow, fallbacks = runner(
        state, pts, ts, mask, has_ts, ext.to(dev), rels)
    overflow = overflow.cpu().numpy()
    if overflow.any():
        warnings.warn(
            f"capacity overflow over the sequence: {overflow[0]} downsample "
            f"voxels, {overflow[1]} source voxels, {overflow[2]} map inserts "
            f"dropped — raise max_downsampled/max_source/map_capacity")
    poses = poses.cpu().numpy().astype(np.float64)
    if return_stats:
        return poses, final_state, {"overflow": overflow,
                                    "exact_fallback_frames": int(fallbacks)}
    return poses, final_state
