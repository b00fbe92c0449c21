"""Offline processing of a whole sequence (the reference OfflineNode loop).

``_write_scan`` writes every lane's padded rows (points, stamps, mask,
has_ts; the one-stamp-a-point rule, the ``max_points`` cut): into fresh
arrays for ``pad_sequence``, ``pad_batch`` and ``BatchedOdometryRunner.
step``, and into ``run_device``'s reused slots a frame at a time.  The
per-frame recurrence (pose, map, threshold) advances in a Python loop over
frames whose steps read nothing back to the host, and the stationary gate
runs on the device.  ``make_batched_sequence_runner`` advances B
independent sequences in lock-step, each frame of all B in the launches of
one frame (the GN solves of the batch in one kernel launch): the
multi-bag answer to the reference OfflineNode's one bag at a time.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from .config import Config
from .models import pipeline
from .ops import hashmap, se3, threshold
from .runtime import resolve_device
from .utils import profiling

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


def make_sequence_runner(config: Config, device=None, eager: bool = False):
    """Build the sequence runner: ``run(state, pts, ts, mask, has_ts,
    extrinsic, rels) -> (final_state, poses (F, 4, 4), overflow (3,),
    fallbacks (), counts (5,))``.

    ``overflow`` totals [downsample drops, source drops, insert failures]
    over the sequence; ``fallbacks`` (int32) counts the active frames on
    which an exact mode's certificate failed and the full-27 loop
    recomputed the solve; ``counts`` sums the active frames'
    ``FrameOutputs.counts`` (``pipeline.COUNTS``: frames, GN passes, live
    sources, fallbacks, fallback trips), one addition a frame.  ``device``
    (``None`` = CUDA; raises if absent) is where the inputs must live.

    Each frame runs through the runner's ``pipeline.Step``, under every
    configuration: on a CUDA device one replay a frame of a CUDA graph
    captured at the first frame of each static shape (under the certified
    and pruned exact modes the full-27 loop inside it, run on the device on
    a frame that falls back, as JAX's ``lax.cond`` runs it), the state
    updated in place in the step's buffers and returned as a copy at the
    end.  ``fallbacks`` reads each frame's ``exact_fallback`` output
    on the device.  The runner is cached per (config, device) as JAX's is,
    so a later sequence of the same shapes replays the same graphs.
    ``eager=True`` runs ``register_frame`` op by op (the baseline a replay
    is held to).
    """
    return _make_runner(config, resolve_device(device), STATIONARY_GATE,
                        False, eager)


def make_batched_sequence_runner(config: Config, device=None,
                                 stationary_gate: float = STATIONARY_GATE,
                                 eager: bool = False):
    """Build the runner of B independent sequences in lock-step:
    ``run(state, pts (F, B, N, 3), ts (F, B, N), mask (F, B, N), has_ts
    (F, B), extrinsic (4, 4) shared, rels (F, B, 4, 4)) -> (final_state,
    poses (F, B, 4, 4), overflow (B, 3), fallbacks (B,), counts (B, 5))``,
    with ``state`` from ``init_batched_state``.

    The same frame loop as ``make_sequence_runner`` (and the same graph
    replays a frame, and ``eager``) with a batch axis on every tensor: a
    frame of B sequences issues the launches of one frame, the GN solves
    of all B in one kernel launch.  A sequence shorter than the batch's
    pads with identity odometry: its frames past the end are stationary
    and leave its state as it was.  ``stationary_gate`` is the |log(rel)|
    below which a frame is stationary (JAX's ``run_device`` fixes it at
    1e-3).  Under an exact mode the full-27 loop runs on the batch where
    any of a batched frame's (B,) fallback flags is set (on the device, or
    eagerly after one read-back of the flags), and ``fallbacks`` counts
    each sequence's fallback frames.

    ``run(state, frames, extrinsic, rels)`` takes the frames one at a time
    instead: ``frames`` yields each batched frame's ``(points (B, N, 3),
    timestamps (B, N), mask (B, N), has_ts (B,))`` on the device, in
    order, ``rels.shape[0]`` of them, and is asked for frame f + 1 only
    after frame f's launches were issued (``BatchedOdometryRunner.
    run_device`` packs and uploads a frame there while the device runs the
    one before).
    """
    return _make_runner(config, resolve_device(device), stationary_gate,
                        True, eager)


@functools.lru_cache(maxsize=8)
def _make_runner(config: Config, dev: torch.device, stationary_gate: float,
                 batched: bool, eager: bool):
    if eager:
        register = functools.partial(pipeline.register_frame, config=config)
    else:
        register = pipeline.Step(config, device=dev)
    return _runner(config, dev, stationary_gate, batched, register)


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


def _runner(config: Config, dev, stationary_gate: float, batched: bool,
            register):
    """The frame loop over ``register(state, points, timestamps, mask,
    has_timestamps, lidar_to_base, relative_odometry, active=,
    rel_twist_in_lidar=)``: ``register_frame`` with its config bound, a
    ``pipeline.Step`` (whose state lives in its buffers during the loop
    and is copied out at the end), or the map-sharded step."""
    stepped = isinstance(register, pipeline.Step)

    def run(state, *inputs):
        *frames, extrinsic, rels = inputs
        if len(frames) == 4:  # padded (F, [B,] N, ...) tensors
            pts = frames[0]
            for t in (*frames, extrinsic, rels, state.pose):
                if t.device.type != dev.type:
                    raise ValueError(f"sequence runner on {dev}: got a "
                                     f"tensor on {t.device}")
            if pts.dim() != 3 + batched \
                    or rels.shape[:-2] != pts.shape[:-2] \
                    or state.pose.shape[:-2] != pts.shape[1:-2]:
                raise ValueError(
                    f"sequence runner: points {tuple(pts.shape)}, odometry "
                    f"{tuple(rels.shape)} and a state of poses "
                    f"{tuple(state.pose.shape)} do not match (F, "
                    f"{'B, ' if batched else ''}N, 3)")
            frames = zip(*frames)
        else:  # a source of each frame's four inputs, in order
            (frames,) = frames
        active, twists = _per_frame_constants(rels, extrinsic, config,
                                              stationary_gate)
        lead = state.pose.shape[:-2]  # (B,) in a batch
        poses = torch.empty((rels.shape[0], *state.pose.shape),
                            dtype=state.pose.dtype, device=dev)
        overflow = torch.zeros(lead + (len(pipeline.OVERFLOW),),
                               dtype=torch.int32, device=dev)
        counts = torch.zeros(lead + (len(pipeline.COUNTS),),
                             dtype=torch.int32, device=dev)
        with profiling.span("kicp.frames"):
            for f, (p, t, m, h) in enumerate(frames):
                state, out = register(
                    state, p, t, m, h, extrinsic, rels[f], active=active[f],
                    rel_twist_in_lidar=None if twists is None else twists[f])
                poses[f] = state.pose
                overflow += out.overflow
                counts += out.counts
        if stepped:
            state = pipeline.clone_state(state)
        fallbacks = counts[..., pipeline.COUNTS.index("exact_fallback_frames")]
        return state, poses, overflow, fallbacks, counts

    #: the runner's ``pipeline.Step`` (its graphs), or None on the eager loop
    run.step = register if stepped else None
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
    f, n = len(frames), config.max_points
    arrays = (np.zeros((f, n, 3), np.float32), np.zeros((f, n), np.float32),
              np.zeros((f, n), bool), np.zeros((f,), bool))
    cut = [_write_scan(arrays, i, *_scan(
        fr, None if timestamps is None else timestamps[i]))
        for i, fr in enumerate(frames)]
    _warn_truncated(cut, n, stacklevel=3)
    return (*arrays, _odometry(rel_odometry, f))


def _scan(frame, timestamps=None):
    """A frame as ``pad_sequence`` reads it: ``(points (M, 3) float32,
    stamps (M,) float32 or None)``.  ``frame`` is ``(points, stamps)`` or
    plain points; ``timestamps`` replaces its stamps; stamps count only
    with exactly one a point."""
    p, t = frame if isinstance(frame, tuple) else (frame, None)
    if timestamps is not None:
        t = timestamps
    p = np.asarray(p, np.float32).reshape(-1, 3)
    if t is None or len(t) != len(p):
        return p, None
    return p, np.asarray(t, np.float32)


def _write_scan(arrays, i: int, points, stamps, reach: int = 0) -> int:
    """Write one lane's scan (``_scan``'s pair) into row ``i`` of (B, N,
    ...) host arrays ``(points, stamps, mask, has_ts)``: its first N points,
    their stamps (zeros and ``has_ts`` False without), and its mask.  Of
    the rows past the scan only those below ``reach``, how far the row's
    last occupant wrote (0 in fresh arrays), are zeroed.  Returns the
    points cut at N (``Config.max_points``)."""
    pts, ts, mask, has_ts = arrays
    k = min(len(points), pts.shape[1])
    pts[i, :k] = points[:k]
    if stamps is not None:
        ts[i, :k] = stamps[:k]
    elif reach:
        ts[i, :min(k, reach)] = 0
    if k < reach:
        pts[i, k:reach] = 0
        ts[i, k:reach] = 0
        mask[i, k:reach] = False
    else:
        mask[i, reach:k] = True
    has_ts[i] = stamps is not None
    return len(points) - k


def _odometry(rel_odometry, f: int):
    """(f, 4, 4) float32 deltas of a sequence's first ``f`` frames: a
    missing list or delta is the identity."""
    rels = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    for i in range(f):
        if rel_odometry is not None and rel_odometry[i] is not None:
            rels[i] = np.asarray(rel_odometry[i], np.float32)
    return rels


def _warn_truncated(cut, max_points: int, stacklevel: int = 2):
    """Warn of the scans of one sequence (``cut``: the points
    ``_write_scan`` cut from each) longer than ``Config.max_points``:
    truncation removes an angular sector of a spinning lidar and degrades
    registration."""
    points, scans = int(np.sum(cut)), int(np.count_nonzero(cut))
    if points:
        warnings.warn(
            f"pad_sequence dropped {points} points from {scans}/{len(cut)} "
            f"scans longer than Config.max_points={max_points}; scan-tail "
            f"truncation removes an angular sector and degrades accuracy — "
            f"raise max_points", stacklevel=stacklevel)


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
    arrays = (np.zeros((f, b, n, 3), np.float32),
              np.zeros((f, b, n), np.float32), np.zeros((f, b, n), bool),
              np.zeros((f, b), bool))
    rels = np.tile(np.eye(4, dtype=np.float32), (f, b, 1, 1))
    for i, s in enumerate(sequences):
        frames = s["frames"]
        rels[:len(frames), i] = _odometry(s["rel_odometry"], len(frames))
        cut = [_write_scan([a[k] for a in arrays], i, *_scan(fr))
               for k, fr in enumerate(frames)]
        _warn_truncated(cut, n, stacklevel=3)
    return (*arrays, rels)


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
    final_state, poses, overflow, fallbacks, _ = runner(
        state, pts, ts, mask, has_ts, ext.to(dev), rels)
    overflow = overflow.cpu().numpy()
    if overflow.any():
        o = dict(zip(pipeline.OVERFLOW, overflow.tolist()))
        warnings.warn(
            f"capacity overflow over the sequence: {o['downsample_dropped']} "
            f"downsample voxels, {o['source_dropped']} source voxels, "
            f"{o['insert_failed']} map inserts dropped — raise "
            f"max_downsampled/max_source/map_capacity")
    poses = poses.cpu().numpy().astype(np.float64)
    if return_stats:
        return poses, final_state, {"overflow": overflow,
                                    "exact_fallback_frames": int(fallbacks)}
    return poses, final_state
