"""Host-side runner for batches of independent sequences.

The answer to "process many bags": instead of the reference's one bag at a
time (offline_node.cpp), B sequences advance in lock-step, padded to shared
static shapes, every frame of the batch in the launches of one frame
(``offline.make_batched_sequence_runner``), on a card as CUDA graph
replays (``pipeline.Step``: one a batched frame, under every mode).  Given a (data, map) mesh, the
sequences are split over the data ranks and each sequence's map over the
map ranks (``parallel.sharded``).
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
from ..utils import profiling
from . import sharded


class BatchedOdometryRunner:
    """Lock-step batched odometry of ``batch`` sequences.

    ``stationary_gate``: a frame whose odometry |log(rel)| is at most this
    is stationary and leaves its sequence's state as it was, in ``step``
    (gated on the host in float64) and in ``run_device`` (on the device)
    alike.  ``mesh`` ``None`` runs the batch on ``device`` (``None`` means
    CUDA; raises if absent).  With a (data, map) mesh (``parallel.
    make_mesh``) every rank makes the same calls with the whole batch; the
    rank keeps its rows of the state (``init_sharded_state``) on the
    mesh's device, and the poses returned are the whole batch's.
    ``stats`` holds the operator's counts of the frames ``run_device`` ran.
    """

    def __init__(self, config: Config, batch: int, mesh=None,
                 extrinsic=None, stationary_gate: float = STATIONARY_GATE,
                 dtype=torch.float32, device=None):
        self.config = config
        self.batch = batch
        self.mesh = mesh
        self.dtype = dtype
        self.extrinsic = (np.eye(4) if extrinsic is None
                          else np.asarray(extrinsic, np.float64))
        self.stationary_gate = stationary_gate
        if mesh is None:
            self.device = resolve_device(device)
            self.state = init_batched_state(config, batch, dtype, self.device)
            # the batched step (graph replays a batched frame on a card)
            self._frame = pipeline.Step(config, device=self.device)
        else:
            self.device = sharded.mesh_device(mesh)
            self.state = sharded.init_sharded_state(config, mesh, batch,
                                                    dtype)
            self._step = sharded.make_sharded_step(config, mesh)
        self._seq_runner = None
        self.poses = [[] for _ in range(batch)]
        #: the operator's counts, one int64 entry a sequence, summed over
        #: the frames ``run_device`` ran that the stationary gate let
        #: through (``step`` and ``run`` read back only the poses):
        #: ``frames``, ``gn_passes`` (the GN kernel's passes, without the
        #: full-27 fallback loop's trips), ``gn_sources`` (live sources)
        #: and ``exact_fallback_frames`` (frames an exact mode re-solved
        #: through the full-27 loop)
        self.stats = {key: np.zeros(batch, np.int64)
                      for key in pipeline.COUNTS}

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

        args = (self._tensor(pts), self._tensor(ts), self._tensor(mask),
                self._tensor(has_ts), self._ext(),
                self._tensor(rel).to(self.dtype))
        if self.mesh is None:
            self.state, _ = self._frame(self.state, *args,
                                        active=self._tensor(active))
            poses = self.state.pose
        else:
            self.state, poses, _ = self._step(self.state, *args,
                                              self._tensor(active))
        poses = poses.cpu().numpy().astype(np.float64)
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
        ``self.poses`` (each sequence's true length) and returns it, and
        adds the frames' counts to ``stats``, read back with the overflow
        totals.  Raises on more sequences than the batch.
        """
        self._check_count(len(sequences))
        b = self.batch
        with profiling.span("kicp.run_device"):
            with profiling.span("kicp.pad_batch"):
                arrays = pad_batch(sequences, self.config, b)
            num_frames = arrays[0].shape[0]
            if self._seq_runner is None:
                self._seq_runner = (
                    make_batched_sequence_runner(self.config, self.device,
                                                 self.stationary_gate)
                    if self.mesh is None else
                    sharded.make_sharded_sequence_runner(
                        self.config, self.mesh, self.stationary_gate))
            with profiling.span("kicp.upload"):
                *inputs, rels = (self._tensor(a) for a in arrays)
                inputs += [self._ext(), rels.to(self.dtype)]
            self.state, poses, overflow, _, counts = self._seq_runner(
                self.state, *inputs)
            with profiling.span("kicp.readback"):
                poses = poses.cpu().numpy().astype(np.float64)
                # the overflow totals and the counts in one transfer
                tallies = torch.cat([overflow, counts], -1).cpu().numpy()
            overflow, counts = tallies[:, :3], tallies[:, 3:]
            self._tally(counts)
            for i in range(b):
                f_i = (len(sequences[i]["frames"]) if i < len(sequences)
                       else num_frames)
                self.poses[i].extend(list(poses[:f_i, i]))
        if overflow.any():
            warnings.warn(
                f"capacity overflow per sequence {overflow.tolist()} — "
                f"raise max_downsampled/max_source/map_capacity")
        return self.poses

    def _tally(self, counts):
        """Add (B, 4) per-sequence counts (``pipeline.COUNTS``) to
        ``stats``, and to the trace's ``gn`` counter while recording."""
        for key, column in zip(pipeline.COUNTS, counts.T):
            self.stats[key] += column
        frames, passes, sources, fallbacks = counts.sum(0).tolist()
        profiling.count("gn", frames=frames, passes=passes, sources=sources,
                        fallbacks=fallbacks)

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
