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
from ..offline import (STATIONARY_GATE, _odometry, _scan, _warn_truncated,
                       _write_scan, init_batched_state,
                       make_batched_sequence_runner)
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
        self._ring = None  # run_device's _FrameRing, built at its first call
        self.poses = [[] for _ in range(batch)]
        #: the operator's counts, one int64 entry a sequence, summed over
        #: the frames ``run_device`` ran that the stationary gate let
        #: through (``step`` and ``run`` read back only the poses):
        #: ``frames``, ``gn_passes`` (the GN kernel's passes, without the
        #: full-27 fallback loop's trips), ``gn_sources`` (live sources),
        #: ``exact_fallback_frames`` (frames an exact mode re-solved
        #: through the full-27 loop) and ``exact_fallback_trips`` (that
        #: loop's trips on those frames)
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

        A scan past ``Config.max_points`` loses its tail, with
        ``pad_sequence``'s warning of the points cut.

        Returns (B, 4, 4) numpy poses after the step.
        """
        self._check_count(len(frames))
        b, n = self.batch, self.config.max_points
        arrays = (np.zeros((b, n, 3), np.float32),
                  np.zeros((b, n), np.float32), np.zeros((b, n), bool),
                  np.zeros((b,), bool))
        rel = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        active = np.zeros((b,), bool)
        cut = np.zeros(len(frames), np.int64)
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
            t = (timestamps[i] if timestamps is not None
                 and i < len(timestamps) else None)
            cut[i] = _write_scan(arrays, i, *_scan(f, t))
        _warn_truncated(cut, n, stacklevel=3)

        args = (*(self._tensor(a) for a in arrays), self._ext(),
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
        sequence runner, with no host round trip a frame.

        Each batched frame is packed into one of two reused host slots
        (``_FrameRing``: pinned on a card) and copied to the device while
        the device runs the frame before, on a mesh as without one.
        Ragged sequence lengths (and rows past ``len(sequences)``) pad
        with identity odometry: stationary frames whose state updates are
        masked, under this runner's ``stationary_gate``.  Appends to
        ``self.poses`` (each sequence's true length) and returns it, and
        adds the frames' counts to ``stats``, read back with the overflow
        totals.  Raises on more sequences than the batch.
        """
        self._check_count(len(sequences))
        b = self.batch
        num_frames = max(len(s["frames"]) for s in sequences)
        with profiling.span("kicp.run_device"):
            if self._seq_runner is None:
                self._seq_runner = (
                    make_batched_sequence_runner(self.config, self.device,
                                                 self.stationary_gate)
                    if self.mesh is None else
                    sharded.make_sharded_sequence_runner(
                        self.config, self.mesh, self.stationary_gate))
                self._ring = _FrameRing(b, self.config.max_points,
                                        self.device)
            rels = np.tile(np.eye(4, dtype=np.float32), (num_frames, b, 1, 1))
            for i, s in enumerate(sequences):
                f_i = len(s["frames"])
                rels[:f_i, i] = _odometry(s["rel_odometry"], f_i)
            self.state, poses, overflow, _, counts = self._seq_runner(
                self.state, self._ring.frames(sequences, num_frames),
                self._ext(), self._tensor(rels).to(self.dtype))
            with profiling.span("kicp.readback"):
                poses = poses.cpu().numpy().astype(np.float64)
                # the counts and the overflow totals in one transfer
                tallies = pipeline.pack_tallies(counts, overflow)
                _, counts, overflow = pipeline.unpack_tallies(
                    tallies.cpu().numpy())
            pipeline.add_counts(self.stats, counts)
            profiling.count("stream", frames=num_frames,
                            waits=self._ring.waits)
            for i, s in enumerate(sequences):
                _warn_truncated(self._ring.cut[:len(s["frames"]), i],
                                self.config.max_points, stacklevel=3)
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


class _FrameRing:
    """Two host slots of one batched frame's inputs, reused by every
    ``run_device`` of a runner: the frame loop asks for frame f + 1 after
    issuing frame f's launches, and the ring packs it into the slot frame
    f did not use and queues its copy to the device while the device runs
    frame f.

    A slot holds points (B, N, 3) float32, stamps (B, N) float32, mask
    (B, N) bool and has_ts (B,) bool, N = ``max_points``: pinned on a
    card, with a twin on the device that the frame reads (refilled in
    place by ``copy_``, which ``pipeline.Step`` sees as a new input), and
    an event recorded after the copy; the host waits on it before packing
    the slot again, so no copy reads a slot being rewritten.  On the CPU
    the slots are plain memory and the copy is synchronous.  A lane's rows
    past its scan hold zeros, as ``offline.pad_batch`` leaves them: a
    repack zeroes only the rows the slot's last occupant wrote past the
    new scan.
    """

    def __init__(self, batch: int, max_points: int, device: torch.device):
        self.slots = [_Slot(batch, max_points, device) for _ in range(2)]
        self.batch = batch
        #: the times the last ``frames`` blocked on a slot's event
        self.waits = 0
        #: (F, B): the points the last ``frames`` cut from each lane's scan
        #: of each frame at ``max_points``
        self.cut = np.zeros((0, batch), np.int64)

    def frames(self, sequences, num_frames: int):
        """Yield each of ``num_frames`` batched frames' (points, stamps,
        mask, has_ts) on the device, packed from ``sequences`` when asked
        for."""
        self.waits = 0
        self.cut = np.zeros((num_frames, self.batch), np.int64)
        for f in range(num_frames):
            slot = self.slots[f % 2]
            if slot.copied is not None and not slot.copied.query():
                self.waits += 1
                slot.copied.synchronize()
            with profiling.span("kicp.pad_batch"):
                slot.pack(sequences, f, self.cut[f])
            with profiling.span("kicp.upload"):
                for twin, host in zip(slot.twin, slot.host):
                    twin.copy_(host, non_blocking=True)
                if slot.copied is not None:
                    slot.copied.record()
            yield slot.twin


#: the scan of a lane past the end of its sequence
_NO_POINTS = np.zeros((0, 3), np.float32)


class _Slot:
    """One batched frame's inputs on the host, their device twin, the
    copy's event (None off a card) and how far each lane's rows were
    written (``reach``: mask set below it, every row zero from it on)."""

    def __init__(self, batch: int, n: int, device: torch.device):
        pin = device.type == "cuda"
        self.host = tuple(
            torch.zeros(shape, dtype=dtype, pin_memory=pin)
            for shape, dtype in (((batch, n, 3), torch.float32),
                                 ((batch, n), torch.float32),
                                 ((batch, n), torch.bool),
                                 ((batch,), torch.bool)))
        self.arrays = tuple(h.numpy() for h in self.host)
        self.twin = tuple(torch.zeros_like(h, device=device)
                          for h in self.host)
        self.copied = torch.cuda.Event() if pin else None
        self.reach = [0] * batch

    def pack(self, sequences, f: int, cut):
        """Write frame ``f`` of each lane (an empty scan past the end of
        its sequence, or past the sequences) with ``offline._write_scan``,
        and the points it cut into ``cut`` (B,)."""
        for i, reach in enumerate(self.reach):
            frames = sequences[i]["frames"] if i < len(sequences) else ()
            p, t = _scan(frames[f]) if f < len(frames) else (_NO_POINTS,
                                                             None)
            cut[i] = c = _write_scan(self.arrays, i, p, t, reach)
            self.reach[i] = len(p) - c
