"""Host-side runner for batches of independent sequences on one card.

The answer to "process many bags": instead of the reference's one bag at a
time (offline_node.cpp), B sequences advance in lock-step, padded to shared
static shapes, every frame of the batch in the launches of one frame
(``offline.make_batched_sequence_runner``).  The JAX package also shards
each sequence's map over a device mesh; that is not ported yet (ROADMAP
A13), so ``mesh`` must be ``None``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import Config
from ..models import pipeline
from ..offline import (STATIONARY_GATE, init_batched_state,
                       make_batched_sequence_runner, pad_batch)
from ..oracle.reference import se3_log
from ..runtime import resolve_device


class BatchedOdometryRunner:
    """Lock-step batched odometry of ``batch`` sequences on one card.

    ``stationary_gate``: a frame whose odometry |log(rel)| is at most this
    is stationary and leaves its sequence's state as it was, in ``step``
    (gated on the host in float64) and in ``run_device`` (on the device)
    alike.  ``device`` ``None`` means CUDA (raises if absent).
    """

    def __init__(self, config: Config, batch: int, mesh=None,
                 extrinsic=None, stationary_gate: float = STATIONARY_GATE,
                 dtype=torch.float32, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (sequences and maps sharded over cards) is "
                "not ported yet: ROADMAP A13 (map sharding); pass mesh=None "
                "for one card")
        self.config = config
        self.batch = batch
        self.device = resolve_device(device)
        self.dtype = dtype
        self.extrinsic = (np.eye(4) if extrinsic is None
                          else np.asarray(extrinsic, np.float64))
        self.stationary_gate = stationary_gate
        self.state = init_batched_state(config, batch, dtype, self.device)
        self._seq_runner = None
        self.poses = [[] for _ in range(batch)]

    def _tensor(self, a):
        return torch.from_numpy(a).to(self.device)

    def _ext(self):
        return torch.tensor(self.extrinsic.astype(np.float32),
                            device=self.device).to(self.dtype)

    def _check_count(self, n: int):
        if n > self.batch:
            raise ValueError(f"{n} sequences for a runner of batch "
                             f"{self.batch}: build one with a larger batch "
                             f"or split the sequences")

    def step(self, frames, rel_odometry, timestamps=None):
        """Advance every sequence by one frame.

        Args:
          frames: list of up to B (N_i, 3) arrays (None or missing =
            sequence finished: a stationary empty frame).
          rel_odometry: list of B (4, 4) deltas (None = identity).
          timestamps: optional list of B (N_i,) normalized times; a frame
            is deskewed only with exactly one stamp per point (as
            ``offline.pad_sequence`` and the server's codec rule).

        Returns (B, 4, 4) numpy poses after the step.
        """
        self._check_count(len(frames))
        b, n = self.batch, self.config.max_points
        pts = np.zeros((b, n, 3), np.float32)
        ts = np.zeros((b, n), np.float32)
        mask = np.zeros((b, n), bool)
        has_ts = np.zeros((b,), bool)
        rel = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        active = np.zeros((b,), bool)
        for i in range(b):
            f = frames[i] if i < len(frames) else None
            r = (rel_odometry[i] if rel_odometry and i < len(rel_odometry)
                 else None)
            if r is not None:
                rel[i] = np.asarray(r, np.float32)
                active[i] = np.linalg.norm(se3_log(
                    np.asarray(r, np.float64))) > self.stationary_gate
            if f is None:
                active[i] = False
                continue
            f = np.asarray(f, np.float32).reshape(-1, 3)
            k = min(len(f), n)
            pts[i, :k] = f[:k]
            mask[i, :k] = True
            t = (timestamps[i] if timestamps is not None
                 and i < len(timestamps) else None)
            if t is not None and len(t) == len(f):
                ts[i, :k] = np.asarray(t, np.float32)[:k]
                has_ts[i] = True

        self.state, _ = pipeline.register_frame(
            self.state, self._tensor(pts), self._tensor(ts),
            self._tensor(mask), self._tensor(has_ts), self._ext(),
            self._tensor(rel).to(self.dtype), self.config,
            active=self._tensor(active))
        poses = self.state.pose.cpu().numpy().astype(np.float64)
        for i in range(b):
            self.poses[i].append(poses[i])
        return poses

    def run_device(self, sequences):
        """Run up to B sequences to completion through the batched
        sequence runner: all frames padded to (F, B, N, ...) tensors once,
        then the frame loop with no host round trip a frame.

        Ragged sequence lengths (and rows past ``len(sequences)``) pad with
        identity odometry: stationary frames whose state updates are
        masked, under this runner's ``stationary_gate``.  Appends to
        ``self.poses`` (each sequence's true length) and returns it.
        Raises on more sequences than the batch.
        """
        self._check_count(len(sequences))
        b = self.batch
        pts, ts, mask, has_ts, rels = pad_batch(sequences, self.config, b)
        num_frames = pts.shape[0]
        if self._seq_runner is None:
            self._seq_runner = make_batched_sequence_runner(
                self.config, self.device, self.stationary_gate)
        self.state, poses, overflow, _ = self._seq_runner(
            self.state, self._tensor(pts), self._tensor(ts),
            self._tensor(mask), self._tensor(has_ts), self._ext(),
            self._tensor(rels).to(self.dtype))
        poses = poses.cpu().numpy().astype(np.float64)
        overflow = overflow.cpu().numpy()
        for i in range(b):
            f_i = (len(sequences[i]["frames"]) if i < len(sequences)
                   else num_frames)
            self.poses[i].extend(list(poses[:f_i, i]))
        if overflow.any():
            warnings.warn(
                f"capacity overflow per sequence {overflow.tolist()} — "
                f"raise max_downsampled/max_source/map_capacity")
        return self.poses

    def run(self, sequences):
        """Run up to B sequences to completion, one ``step`` a frame
        (ragged lengths padded with None).

        ``sequences``: list of dicts with keys ``frames`` (list of
        (points, timestamps)) and ``rel_odometry`` (list of (4, 4)).
        Returns the list of per-sequence pose lists.
        """
        self._check_count(len(sequences))
        num_frames = max(len(s["frames"]) for s in sequences)
        for k in range(num_frames):
            frames, rels, tss = [], [], []
            for s in sequences:
                if k < len(s["frames"]):
                    pts_k, ts_k = s["frames"][k]
                    frames.append(pts_k)
                    tss.append(ts_k)
                    rels.append(s["rel_odometry"][k])
                else:
                    frames.append(None)
                    tss.append(None)
                    rels.append(None)
            self.step(frames, rels, tss)
        return self.poses
