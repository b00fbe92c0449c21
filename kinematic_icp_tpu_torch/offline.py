"""Offline processing of a whole sequence (the reference OfflineNode loop).

All frames are padded into device tensors once; the per-frame recurrence
(pose, map, threshold) then advances in a Python loop over frames whose
steps read nothing back to the host, and the stationary gate runs on the
device.  ``make_batched_sequence_runner`` advances B independent sequences
in lock-step through the same loop, each frame of all B in the launches of
one frame (the GN solves of the batch in one kernel launch): the multi-bag
answer to the reference OfflineNode's one bag at a time.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import Config
from .models import pipeline
from .ops import hashmap, se3, threshold
from .runtime import resolve_device

#: the stationary gate |log(rel)| of the reference server
#: (LidarOdometryServer.cpp:202)
STATIONARY_GATE = 1e-3


def _per_frame_constants(rels, extrinsic, config: Config,
                         stationary_gate: float = STATIONARY_GATE):
    """Pose-independent per-frame values, vectorized over all frames (and
    sequences: ``rels`` (F, 4, 4) or (F, B, 4, 4)).

    Returns (active (F,), twists (F, 6) or None), each with the B axis of
    a batch: the stationary-gate flag |log(rel)| > ``stationary_gate``
    (LidarOdometryServer.cpp:202) and the deskew twist
    ``log(ext^-1 rel ext)`` (KinematicICP.cpp:53-55).
    """
    active = (torch.linalg.vector_norm(se3.se3_log(rels), dim=-1)
              > stationary_gate)
    twists = None
    if config.deskew:
        ext = extrinsic.expand(rels.shape)
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
    return _runner(config, resolve_device(device), STATIONARY_GATE,
                   batched=False)


def make_batched_sequence_runner(config: Config, device=None,
                                 stationary_gate: float = STATIONARY_GATE):
    """Build the runner of B independent sequences in lock-step:
    ``run(state, pts (F, B, N, 3), ts (F, B, N), mask (F, B, N), has_ts
    (F, B), extrinsic (4, 4) shared, rels (F, B, 4, 4)) -> (final_state,
    poses (F, B, 4, 4), overflow (B, 3), fallbacks (B,))``, with ``state``
    from ``init_batched_state``.

    The same frame loop as ``make_sequence_runner`` with a batch axis on
    every tensor: a frame of B sequences issues the launches of one frame,
    the GN solves of all B in one kernel launch.  A sequence shorter than
    the batch's pads with identity odometry: its frames past the end are
    stationary and leave its state as it was.  ``stationary_gate`` is the
    |log(rel)| below which a frame is stationary (JAX's ``run_device``
    fixes it at 1e-3).  Only the candidate-cached registration takes a
    batch; the exact modes raise ``NotImplementedError``.
    """
    return _runner(config, resolve_device(device), stationary_gate,
                   batched=True)


def init_batched_state(config: Config, batch: int, dtype=torch.float32,
                       device=None) -> pipeline.OdometryState:
    """A fresh state replicated over a leading batch axis of ``batch``
    sequences (``device`` ``None`` = CUDA; raises if absent)."""
    state = pipeline.init_state(config, dtype, device=device)
    return pipeline.OdometryState(
        pose=state.pose.expand(batch, 4, 4).clone(),
        map=hashmap.MapState(
            table=state.map.table.expand(batch, *state.map.table.shape
                                         ).clone(),
            bucket_slots=state.map.bucket_slots),
        threshold=threshold.ThresholdState(
            *(t.expand(batch).clone() for t in state.threshold)))


def _runner(config: Config, dev, stationary_gate: float, batched: bool):
    def run(state, pts, ts, mask, has_ts, extrinsic, rels):
        for t in (pts, ts, mask, has_ts, extrinsic, rels, state.pose):
            if t.device.type != dev.type:
                raise ValueError(f"sequence runner on {dev}: got a tensor "
                                 f"on {t.device}")
        if pts.dim() != 3 + batched or rels.shape[:-2] != pts.shape[:-2] \
                or state.pose.shape[:-2] != pts.shape[1:-2]:
            raise ValueError(
                f"sequence runner: points {tuple(pts.shape)}, odometry "
                f"{tuple(rels.shape)} and a state of poses "
                f"{tuple(state.pose.shape)} do not match (F, "
                f"{'B, ' if batched else ''}N, 3)")
        active, twists = _per_frame_constants(rels, extrinsic, config,
                                              stationary_gate)
        lead = pts.shape[1:-2]  # (B,) in a batch
        poses = []
        overflow = torch.zeros(lead + (3,), dtype=torch.int32, device=dev)
        fallbacks = torch.zeros(lead, dtype=torch.int32, device=dev)
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
    A frame is deskewed only with exactly one stamp per point, the rule of
    the server's codec and of the float64 oracle (JAX's ``pad_sequence``
    also takes more stamps than points).  Scans longer than
    ``config.max_points`` are truncated, which removes an angular sector of
    a spinning lidar and degrades registration, so it warns with the total.
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
        if t is not None and len(t) == len(p):
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


def pad_batch(sequences, config: Config, batch: int | None = None):
    """Pack sequences (dicts of ``frames`` and ``rel_odometry`` lists, as
    ``pad_sequence`` takes them) into (F, B, N, ...) numpy arrays for the
    batched sequence runner: F the longest sequence, B ``batch`` (default
    one row a sequence).  A shorter sequence, and every row past the
    sequences, pads with stationary frames (no points, identity odometry).
    """
    b = len(sequences) if batch is None else batch
    f = max(len(s["frames"]) for s in sequences)
    n = config.max_points
    out = (np.zeros((f, b, n, 3), np.float32), np.zeros((f, b, n), np.float32),
           np.zeros((f, b, n), bool), np.zeros((f, b), bool),
           np.tile(np.eye(4, dtype=np.float32), (f, b, 1, 1)))
    for i, s in enumerate(sequences):
        packed = pad_sequence(s["frames"], s["rel_odometry"], config)
        for a, p in zip(out, packed):
            a[:len(p), i] = p
    return out


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
