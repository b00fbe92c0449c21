"""Host-side odometry server: the serving layer, ROS-free.

Counterpart of the reference ``LidarOdometryServer``
(ros/src/kinematic_icp_ros/server/LidarOdometryServer.cpp): it consumes
plain numpy arrays from any ingestion source (bag reader, synthetic
generator, live feed), applies the stationary-skip gate, pads
variable-length scans into power-of-two point buckets, tracks stamped poses
and computes the published twist.  The heavy state (the map) lives on the
device; only the pose, the frame's counts and the overflow totals come back
to the host.

Each frame is shipped as ONE packed buffer (``utils/packing.py``) carrying
points, timestamps, count and the odometry delta, unpacked on the device.
Blocking mode costs one upload, one step and one readback of a small int32
vector holding the pose's bits, the frame's counts (GN passes, live
sources, exact fallback) and the running overflow totals.  On a card
a step is one replay of a CUDA graph, one per (bucket, codec, dtype) and
one per chunk-scan (the counterpart of the JAX server's executables),
captured at the bucket's first frame or by ``warmup``; under an exact mode
the fallback runs inside the same graph, on the device, where the flag is
set (a conditional node, ``utils.cuda_graph``); the server's state,
its overflow totals, extrinsic and upload buffers are the graphs' fixed
buffers, refilled in place (``state`` assignment, ``set_pose``).  Streaming
mode stages ``stream_chunk`` frames host-side and uploads them as one
transfer, then either (``stream_mode="steps"``) runs the same per-frame step
on each row, so streaming and blocking trajectories are bitwise identical,
or (``stream_mode="scan"``) runs every row of the chunk with the padding
rows masked through their header's ``active`` flag.  Streamed results go
into a device-side log that is read back only at the overflow check or at
``drain()``; each ``drain()`` that finds frames in flight records one
``serve`` count (``utils.profiling``) of the frames streamed since the last,
the chunks uploaded and the host's waits on the device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import Config, ServerConfig
from .models import pipeline
from .oracle import reference as _ref  # float64 SE(3) helpers for host math
from .ops import cuda_build, registration
from .runtime import resolve_device
from .utils import packing, profiling
from .utils.cuda_graph import StaticCall, refill

#: the state's float types -> numpy's, to read a pose back from its bits
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def next_bucket(n: int, max_points: int, min_bucket: int = 1024) -> int:
    """Smallest power-of-two >= n (clamped to [min_bucket, max_points])."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_points)


def _ret(state, counts, acc):
    """One step's readback row (``pipeline.pack_tallies``): the pose's bits
    as int32 words (16 for float32, 32 for float64), the frame's (5,) int32
    counts and the running (3,) int32 overflow totals, so one transfer
    returns them exactly."""
    return pipeline.pack_tallies(counts, acc, head=(
        state.pose.reshape(-1).contiguous().view(torch.int32),))


def _server_step(state, acc, packed, extrinsic, config: Config, bucket: int,
                 codec: str, with_active: bool = False):
    """One frame over a packed upload row: (state, acc, packed (W,) int16,
    ext) -> (state', acc', ret).  With ``with_active`` the header's active
    flag masks the state update (the chunk-scan mode's padding rows)."""
    unpacked = packing.unpack_frame(packed, bucket, codec,
                                    return_active=with_active)
    pts, ts, mask, has_ts, rel = unpacked[:5]
    dtype = state.pose.dtype
    state, out = pipeline.register_frame(
        state, pts, ts, mask, has_ts, extrinsic.to(dtype), rel.to(dtype),
        config, active=unpacked[5] if with_active else None)
    acc = acc + out.overflow
    return state, acc, _ret(state, out.counts, acc)


def _server_call(config: Config, bucket: int, codec: str, bucket_slots: int,
                 rows: int):
    """The function of a server's static call over its buffers (pose,
    table, threshold sums, overflow totals, the packed upload, extrinsic):
    one frame of a (W,) upload (``rows`` 0), or every row of a (rows, W)
    chunk with padding rows masked (the chunk-scan).  Writes the new state
    and totals into their buffers and returns the ret row (rows)."""
    def fn(pose, table, sse, n, acc, packed, extrinsic):
        state = pipeline.state_of((pose, table, sse, n), bucket_slots)
        if rows == 0:
            state, new_acc, ret = _server_step(state, acc, packed, extrinsic,
                                               config, bucket, codec)
        else:
            new_acc, rets = acc, []
            for row in packed:
                state, new_acc, r = _server_step(
                    state, new_acc, row, extrinsic, config, bucket, codec,
                    with_active=True)
                rets.append(r)
            ret = torch.stack(rets)
        refill((pose, table, sse, n, acc),
               (*pipeline.state_tensors(state), new_acc))
        return ret

    return fn


class _PendingPose:
    """Marker in ``poses_with_stamps``: pose = row ``idx`` of the device
    ret log, materialized at ``drain()`` in one transfer."""
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx


class LidarOdometryServer:
    """Stateful odometry service over the per-frame pipeline step.

    Mirrors the reference server's behaviour:
      * lazy pose initialization from an externally supplied initial pose
        (the tf ``odom -> base`` seed, LidarOdometryServer.cpp:160-184),
      * per-frame stationary gate ``|log(delta)| > 1e-3`` (cpp:202),
      * twist = log(last^-1 new)/dt (cpp:210-214),
      * ``set_pose`` service that re-seeds the pose and clears map+threshold.

    Args:
      device: where the state lives and the steps run; ``None`` means CUDA
        (raises without a card), ``"cpu"`` runs on the CPU.
      dtype: the state's float type; poses come back in it (a float64
        server returns float64 poses equal to ``state.pose``).
      upload: frame upload codec: "f32" (default) ships raw float bits
        (lossless), "u16" quantizes positions to the frame bounding box
        (~0.9 mm worst case at 120 m extent; half the bytes).
      stream_chunk: frames staged per host->device transfer in streaming
        mode (``register_frame(blocking=False)``).
      stream_mode: "steps" (default) runs the blocking mode's per-frame step
        on each row of an uploaded chunk, bitwise identical to blocking
        mode.  "scan" runs all ``stream_chunk`` rows of the chunk, padding
        partial chunks with inactive all-zero rows whose state updates are
        masked; equal to "steps" to the last ulp, not bit for bit.
      overflow_check_interval: in streaming mode, read the device-side
        overflow totals every this many registered frames so a capacity
        problem warns mid-stream instead of only at ``drain()`` (0 disables
        the periodic check).
      eager: run each step op by op over the same buffers instead of
        replaying its CUDA graphs (the baseline a replay is held to), as
        the CPU always does.  Under the certified and pruned exact modes a
        step is still one graph: the full-27 loop runs inside it where the
        fallback flag is set, a conditional node (a chunk-scan has one a
        row); eagerly the flag is read back once a frame.

    The operator's counts: ``overflow_stats`` (data loss) and
    ``frame_stats`` (running totals of the registered frames, their GN
    kernel passes, live sources, exact fallbacks and their loop trips),
    both read from the rows the server reads back anyway.
    """

    def __init__(self, config: Config | None = None,
                 server_config: ServerConfig | None = None,
                 extrinsic=None, initial_pose=None, dtype=torch.float32,
                 upload: str = "f32", stream_chunk: int = 8,
                 stream_mode: str = "steps",
                 overflow_check_interval: int = 64, device=None,
                 eager: bool = False):
        self.device = resolve_device(device)
        self.config = config or Config()
        self.server_config = server_config or ServerConfig()
        if upload not in packing.CODECS:
            raise ValueError(f"upload {upload!r}")
        if stream_mode not in ("steps", "scan"):
            raise ValueError(f"stream_mode {stream_mode!r}")
        if dtype not in _NP_DTYPE:
            raise ValueError(f"dtype {dtype}")
        self.upload = upload
        self.stream_mode = stream_mode
        self.stream_chunk = max(1, int(stream_chunk))
        self.overflow_check_interval = int(overflow_check_interval)
        self._extrinsic = np.eye(4) if extrinsic is None else np.asarray(
            extrinsic, np.float64)
        self.dtype = dtype
        # the buffers every step runs over: state, overflow totals and
        # extrinsic, refilled in place and never rebound
        self._state = pipeline.init_state(self.config, dtype, initial_pose,
                                          device=self.device)
        self._ovf_acc = torch.zeros(3, dtype=torch.int32, device=self.device)
        self._ext_dev = torch.as_tensor(self._extrinsic.astype(np.float32),
                                        device=self.device)
        self._capture = self.device.type == "cuda" and not eager
        self._pool = (torch.cuda.graph_pool_handle() if self._capture
                      else None)
        #: (bucket, chunk rows or 0) -> (the upload buffer, its StaticCall)
        self._calls: dict[tuple[int, int], tuple[torch.Tensor,
                                                 StaticCall]] = {}
        self.last_stamp: float | None = None
        #: (stamp, pose) records; a pose is a (4,4) float64 numpy array
        #: once settled, or (until ``drain()``) a ``_PendingPose`` marker
        #: indexing the device-side ret log for frames still in flight
        #: from streaming mode.
        self.poses_with_stamps: list[tuple[float, np.ndarray]] = []
        self.frames_registered = 0
        self.frames_skipped = 0
        #: data-loss counters: the reference's dynamic containers drop
        #: nothing, so every drop is counted and warned once: raw points
        #: truncated past max_points, downsample/source voxels past
        #: capacity, map-insert bucket overflows.  The device-side totals
        #: live in ``_ovf_acc`` (a running (3,) int32 accumulator) and are
        #: mirrored here at every sync point.
        self.overflow_stats = {"points_truncated": 0,
                               **dict.fromkeys(pipeline.OVERFLOW, 0)}
        self._overflow_warned = False
        #: the operator's counts, running totals over the registered
        #: frames read back so far (a blocking frame at its return, a
        #: streamed one at ``drain()``): ``frames``, ``gn_passes`` (the GN
        #: kernel's passes, without the full-27 fallback loop's trips),
        #: ``gn_sources`` (live sources), ``exact_fallback_frames``
        #: (frames an exact mode re-solved through the full-27 loop) and
        #: ``exact_fallback_trips`` (that loop's trips on those frames)
        self.frame_stats = dict.fromkeys(pipeline.COUNTS, 0)
        # streaming staging (see register_frame(blocking=False) / drain())
        self._staging: np.ndarray | None = None   # (K, W) u16
        self._staging_bucket = 0
        self._staging_rows = 0
        #: records of not-yet-dispatched streaming frames, in arrival
        #: order: ("frame", stamp_or_None) consumes the next staging row;
        #: ("skip", stamp) is a stationary frame re-using the latest pose.
        self._stream_records: list[tuple[str, float | None]] = []
        self._last_ret = None  # latest dispatched step's ret row (device)
        self._last_pose_np = None  # host mirror of state.pose (f64), if known
        self._frames_since_ovf_check = 0
        #: device-side (cap, R) int32 log of every streamed step's ret,
        #: grown by powers of two; drain() fetches it in ONE transfer
        self._ret_log = None
        self._ret_count = 0
        #: the ``serve`` count of the frames streamed since the last
        #: ``drain()``: ``frames``, ``flushes`` (chunks uploaded) and
        #: ``waits`` (the host blocked on the device: a flush's pageable
        #: upload, every read-back)
        self._served = dict.fromkeys(("frames", "flushes", "waits"), 0)
        # message-interface state (lazy init like LidarOdometryServer.cpp:160)
        self._initialized = initial_pose is not None or extrinsic is not None
        self._stamps_handler = None

    # ------------------------------------------------------------------
    @property
    def extrinsic(self) -> np.ndarray:
        return self._extrinsic

    @extrinsic.setter
    def extrinsic(self, value):
        self._extrinsic = np.asarray(value, np.float64)
        self._ext_dev.copy_(torch.from_numpy(
            self._extrinsic.astype(np.float32)))

    @property
    def state(self) -> pipeline.OdometryState:
        """The server's state: the buffers its steps update in place.
        Assigning a state (a checkpoint's) copies it into them; it must
        have the server's shapes and dtype."""
        return self._state

    @state.setter
    def state(self, value: pipeline.OdometryState):
        have = pipeline.state_tensors(self._state)
        given = pipeline.state_tensors(value)
        if value.map.bucket_slots != self._state.map.bucket_slots or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(have, given)):
            raise ValueError(
                "the server's state keeps its shapes and dtype: got "
                + ", ".join(f"{tuple(b.shape)} {b.dtype}" for b in given)
                + " for "
                + ", ".join(f"{tuple(a.shape)} {a.dtype}" for a in have))
        refill(have, given)

    @property
    def pose(self) -> np.ndarray:
        self._flush()
        return self.state.pose.cpu().numpy().astype(np.float64)

    def set_pose(self, pose):
        """Re-seed pose; clears map and threshold (KinematicICP.hpp:86-90)."""
        self._flush()
        self.state = pipeline.set_pose(self._state, torch.as_tensor(
            np.asarray(pose, np.float64), dtype=self.dtype,
            device=self.device), self.config)
        self._last_pose_np = self.state.pose.cpu().numpy().astype(np.float64)

    def local_map_pointcloud(self) -> np.ndarray:
        from .ops import hashmap
        self._flush()
        pts, mask = hashmap.pointcloud(self.state.map, self.config.voxel_size)
        arr = torch.stack([pts.x, pts.y, pts.z], dim=-1)
        return arr[mask].cpu().numpy()

    # ------------------------------------------------------------------
    def _warn_overflow(self, msg: str):
        """Warn once per server (counters in ``overflow_stats`` keep the
        full tally): data loss must never be silent."""
        if not self._overflow_warned:
            warnings.warn(f"kinematic_icp_tpu_torch data loss: {msg}",
                          RuntimeWarning, stacklevel=3)
            self._overflow_warned = True

    def _call(self, bucket: int, rows: int = 0):
        """(upload buffer, StaticCall) of a bucket's step: one frame
        (``rows`` 0), or the chunk-scan of ``rows`` frames; built at first
        use, captured at its first call on a card."""
        key = (bucket, rows)
        if key not in self._calls:
            words = packing.packed_words(bucket, self.upload)
            packed = torch.zeros((rows, words) if rows else (words,),
                                 dtype=torch.int16, device=self.device)
            fn = _server_call(self.config, bucket, self.upload,
                              self._state.map.bucket_slots, rows)
            self._calls[key] = (packed, StaticCall(
                fn, (*pipeline.state_tensors(self._state), self._ovf_acc,
                     packed, self._ext_dev),
                capture=self._capture, pool=self._pool))
        return self._calls[key]

    def _step(self, bucket: int, packed):
        """One frame of ``bucket``: ``packed`` (a host u16 buffer, or a
        row of an uploaded chunk) into the step's upload buffer, then the
        step.  Returns its ret row, valid until the bucket's next step."""
        buf, call = self._call(bucket)
        self._upload(packed, buf)
        return call()

    def _upload(self, buf, into=None):
        """One copy of packed u16 words (a host array, or int16 bits on
        the device) into ``into`` or a new device tensor, as int16 bits.
        The copy from pageable memory returns once the host buffer is
        read, so the staging buffer may be dropped or reused after it."""
        with profiling.span("kicp.upload"):
            if isinstance(buf, np.ndarray):
                buf = torch.from_numpy(buf.view(np.int16))
            if into is None:
                return buf.to(self.device)
            return into.copy_(buf)

    def warmup(self, num_points: int, streaming: bool = False):
        """Capture the step of the bucket that scans of ``num_points``
        points fall in (with ``streaming`` under ``stream_mode="scan"``,
        the chunk-scan step too; ``"steps"`` replays the blocking step), so
        the bucket's first served frame replays a graph: the counterpart
        of the JAX server's ahead-of-time compile.  The capture's warm-up
        runs on scratch copies of the buffers, so neither the state nor
        the launch counters change.  Without capture (the CPU, ``eager``)
        it builds the CUDA kernels the configuration runs.
        """
        bucket = next_bucket(max(num_points, 1), self.config.max_points)
        self._call(bucket)[1].prepare()
        if streaming and self.stream_mode == "scan":
            self._call(bucket, self.stream_chunk)[1].prepare()
        if (not self._capture and self.device.type == "cuda"
                and registration._resolve_backend(
                    self.config.gn_backend, self.device) == "cuda"):
            cuda_build.load("gn_solve")

    # ------------------------------------------------------------------
    def register_frame(self, points, timestamps=None, relative_odometry=None,
                       stamp: float | None = None, blocking: bool = True):
        """Process one scan.

        Args:
          points: (N, 3) float array, lidar frame.
          timestamps: optional (N,) per-point times normalized to [0, 1]
            (missing, or not one per point -> deskew disabled for this
            frame, like the reference).
          relative_odometry: (4, 4) wheel odometry delta in the base frame
            (identity if unavailable).
          stamp: scan end timestamp in seconds (for twist & TUM output).
          blocking: True (default) returns once the device finished the
            frame and mirrors pose/overflow to the host, the reference's
            synchronous per-message shape (online_node.cpp:40-67): one
            packed upload and one readback a frame.  False is the
            pipelined streaming mode: the frame is STAGED host-side and
            shipped with up to ``stream_chunk - 1`` peers in a single
            transfer; ``pose`` and ``twist`` in the returned dict are None
            (poses settle into ``poses_with_stamps`` as float64 numpy at
            ``drain()``).  In streaming mode the capacity warning fires at
            the periodic overflow check or at ``drain()``.

        Returns dict with pose ((4,4) float64 numpy, or None in streaming
        mode), twist (6,) or None, registered: bool.
        """
        rel = (np.eye(4) if relative_odometry is None
               else np.asarray(relative_odometry, np.float64))
        with profiling.span("kicp.register_frame"):
            if not blocking:
                return self._register_streaming(points, timestamps, rel,
                                                stamp, self._moving(rel))
            return self._register_blocking(points, timestamps, rel, stamp)

    def _moving(self, rel) -> bool:
        """The stationary gate (LidarOdometryServer.cpp:202)."""
        gate = float(np.linalg.norm(_ref.se3_log(rel)))
        return gate > self.server_config.stationary_gate

    def _register_blocking(self, points, timestamps, rel, stamp):
        self._flush()  # settle any staged streaming frames first, in order

        registered = False
        # The pre-step pose is only needed for the twist; the host mirror
        # from the previous blocking frame saves a second readback.
        last_pose = self._last_pose_np
        if last_pose is None:
            last_pose = self.state.pose.cpu().numpy().astype(np.float64)
        new_pose = last_pose
        with profiling.span("kicp.pack"):
            active = self._moving(rel)
            if active:
                points = np.asarray(points, np.float32).reshape(-1, 3)
                n = len(points)
                bucket = next_bucket(max(n, 1), self.config.max_points)
                self._count_truncation(n, bucket)
                buf, _ = packing.pack_frame(points, timestamps, rel, bucket,
                                            self.upload)
        if active:
            ret = self._step(bucket, buf)
            self.frames_registered += 1
            registered = True
            with profiling.span("kicp.readback"):
                ret_np = ret.cpu().numpy()  # the ONE device->host sync
            new_pose = self._pose_from_ret(ret_np)
            _, counts, overflow = pipeline.unpack_tallies(ret_np)
            self._sync_overflow(overflow)
            pipeline.add_counts(self.frame_stats, counts)
        else:
            self.frames_skipped += 1
        self._last_pose_np = new_pose

        twist = None
        if stamp is not None and self.last_stamp is not None:
            dt = stamp - self.last_stamp
            if dt > 0:
                twist = _ref.se3_log(
                    np.linalg.inv(last_pose) @ new_pose) / dt
        if stamp is not None:
            self.last_stamp = stamp
            self.poses_with_stamps.append((stamp, new_pose))
        return {"pose": new_pose, "twist": twist, "registered": registered}

    def _pose_from_ret(self, row: np.ndarray) -> np.ndarray:
        """(4, 4) float64 pose from a ret row's leading int32 words."""
        words, _, _ = pipeline.unpack_tallies(row)
        return (np.ascontiguousarray(words).view(_NP_DTYPE[self.dtype])
                .astype(np.float64).reshape(4, 4))

    # ------------------------------------------------------------------
    def _count_truncation(self, n: int, bucket: int):
        if n > bucket:
            self.overflow_stats["points_truncated"] += n - bucket
            self._warn_overflow(
                f"scan has {n} points > Config.max_points="
                f"{self.config.max_points}; {n - bucket} dropped")

    def _register_streaming(self, points, timestamps, rel, stamp, active):
        """Stage one frame; flush when the chunk fills."""
        if not active:
            self.frames_skipped += 1
            if (not self._stream_records and not self._staging_rows
                    and self._last_pose_np is not None):
                # nothing in flight and the pose is settled host-side
                # (e.g. right after a blocking frame): record immediately
                if stamp is not None:
                    self.last_stamp = stamp
                    self.poses_with_stamps.append(
                        (stamp, self._last_pose_np))
                return {"pose": None, "twist": None, "registered": False}
            # otherwise defer: the pose is whatever the latest in-flight
            # frame produces (resolved in arrival order at flush)
            self._stream_records.append(("skip", stamp))
            if stamp is not None:
                self.last_stamp = stamp
            return {"pose": None, "twist": None, "registered": False}

        points = np.asarray(points, np.float32).reshape(-1, 3)
        n = len(points)
        bucket = next_bucket(max(n, 1), self.config.max_points)
        self._count_truncation(n, bucket)
        if self._staging is not None and bucket != self._staging_bucket:
            self._flush()  # bucket change: ship what we have
        with profiling.span("kicp.pack"):
            if self._staging is None:
                # zeroed: the padding of every row, and the inactive
                # all-zero rows of a partial chunk in scan mode
                self._staging = np.zeros(
                    (self.stream_chunk,
                     packing.packed_words(bucket, self.upload)), np.uint16)
                self._staging_bucket = bucket
                self._staging_rows = 0
            packing.pack_frame_into(self._staging[self._staging_rows],
                                    points, timestamps, rel, self.upload)
        self._staging_rows += 1
        self._last_pose_np = None  # pose advances on device asynchronously
        self._stream_records.append(("frame", stamp))
        self.frames_registered += 1
        if stamp is not None:
            self.last_stamp = stamp
        if self._staging_rows >= self.stream_chunk:
            self._flush()
        return {"pose": None, "twist": None, "registered": True}

    def _append_rets(self, rets):
        """Append (rows, R) ret rows to the device log, growing it by
        powers of two (one copy per growth, one write per append)."""
        rows = int(rets.shape[0])
        cap = 0 if self._ret_log is None else self._ret_log.shape[0]
        need = self._ret_count + rows
        if need > cap:
            new_log = torch.zeros((1 << max(8, (need - 1).bit_length()),
                                   rets.shape[1]),
                                  dtype=torch.int32, device=self.device)
            if self._ret_count:
                new_log[:self._ret_count] = self._ret_log[:self._ret_count]
            self._ret_log = new_log
        self._ret_log[self._ret_count:need] = rets
        self._ret_count = need

    def _flush(self):
        """Upload staged streaming frames (one transfer) and run them,
        resolving pose records in arrival order."""
        records, self._stream_records = self._stream_records, []
        staged = self._staging_rows
        scan_mode = self.stream_mode == "scan"
        cur = self._ret_count - 1   # log row of the latest known pose
        # A stationary record arriving before ANY registered frame resolves
        # to the pre-stream pose; in scan mode the whole chunk runs before
        # the record walk, so capture that pose now (only the very first
        # flush can need it).
        fallback_pose = None
        if (staged and scan_mode and cur < 0
                and records and records[0][0] == "skip"):
            fallback_pose = self._read(self.state.pose).astype(np.float64)
        if staged:
            # the upload from pageable memory waits for the device
            self._served["frames"] += staged
            self._served["flushes"] += 1
            self._served["waits"] += 1
            if scan_mode:
                # every row runs, all-zero padding rows inactive (masked
                # state); all stream_chunk rows append to the log, a pad
                # row carrying the running pose/overflow unchanged
                buf, call = self._call(self._staging_bucket,
                                       self.stream_chunk)
                self._upload(self._staging, buf)
                base = self._ret_count
                rets = call()
                self._append_rets(rets)
                self._last_ret = rets[staged - 1]
                self._frames_since_ovf_check += staged
            else:
                chunk = self._upload(self._staging[:staged])
        nframe = 0
        for kind, stamp in records:
            if kind == "frame":
                if scan_mode:
                    cur = base + nframe
                else:
                    ret = self._step(self._staging_bucket, chunk[nframe])
                    self._append_rets(ret[None])
                    self._last_ret = ret
                    self._frames_since_ovf_check += 1
                    cur = self._ret_count - 1
                nframe += 1
            if stamp is not None:
                # a skip record only exists when frames were in flight at
                # record time (see _register_streaming), so its pose is
                # the latest preceding ret, or the initial pose if the
                # stream started with stationary frames
                if cur >= 0:
                    self.poses_with_stamps.append(
                        (stamp, _PendingPose(cur)))
                else:
                    self.poses_with_stamps.append(
                        (stamp, fallback_pose if fallback_pose is not None
                         else self._read(self.state.pose).astype(
                             np.float64)))
        self._staging = None
        self._staging_rows = 0
        if (self.overflow_check_interval and staged
                and self._frames_since_ovf_check
                >= self.overflow_check_interval):
            self._frames_since_ovf_check = 0
            with profiling.span("kicp.readback"):
                self._sync_overflow(
                    self._read(pipeline.unpack_tallies(self._last_ret)[2]))

    def _read(self, tensor) -> np.ndarray:
        """``tensor`` read back to the host, a wait on the device that the
        ``serve`` count keeps."""
        self._served["waits"] += 1
        return tensor.cpu().numpy()

    def drain(self):
        """Synchronize all in-flight streaming frames.

        Flushes any staged frames, fetches the device-side ret log in ONE
        transfer (which waits for the device), resolves every pending pose
        record from it, and folds the device-side overflow totals into
        ``overflow_stats`` (warning if any capacity overflowed); records
        the ``serve`` count and starts it anew.
        Idempotent; a no-op after blocking calls.
        """
        self._flush()
        if not self._ret_count:
            return  # nothing in flight
        with profiling.span("kicp.readback"):
            log_np = self._read(self._ret_log[:self._ret_count])
        profiling.count("serve", **self._served)
        self._served = dict.fromkeys(self._served, 0)
        _, counts, overflow = pipeline.unpack_tallies(log_np)
        pipeline.add_counts(self.frame_stats, counts.sum(0, dtype=np.int64))
        for i, (s, p) in enumerate(self.poses_with_stamps):
            if isinstance(p, _PendingPose):
                self.poses_with_stamps[i] = (s, self._pose_from_ret(
                    log_np[p.idx]))
        last = log_np[self._ret_count - 1]
        self._sync_overflow(overflow[-1])
        self._last_pose_np = self._pose_from_ret(last)
        self._ret_count = 0  # reuse the log buffer for the next stream

    def _sync_overflow(self, overflow: np.ndarray):
        """Mirror the device-side running totals ((3,) int32 from a step's
        ret row, ``pipeline.OVERFLOW``' columns) into ``overflow_stats``."""
        totals = dict(zip(pipeline.OVERFLOW, np.asarray(overflow).tolist()))
        changed = any(self.overflow_stats[k] != v for k, v in totals.items())
        self.overflow_stats.update(totals)
        if any(totals.values()) and changed:
            self._warn_overflow(
                f"capacity overflow (downsample/source/insert voxels "
                f"dropped: {list(totals.values())} total); raise "
                f"Config.max_downsampled/max_source/map_capacity")

    # ------------------------------------------------------------------
    # Message-level interface (the full behaviour of the reference
    # server: lazy tf init, timestamp handling, odometry delta lookup).
    # ------------------------------------------------------------------
    def register_message(self, msg, tf_buffer):
        """Process one PointCloud2 against a TransformBuffer.

        Mirrors LidarOdometryServer::RegisterFrame (cpp:186-218): the
        cloud's points and per-point times are decoded
        (``timestamps.decode_scan``), then ``register_scan``.  Returns the
        register_frame result dict (or None while initialization is
        pending).
        """
        from .utils.io.timestamps import decode_scan

        with profiling.span("kicp.decode"):
            scan = decode_scan(msg)
        return self.register_scan(scan, tf_buffer)

    def register_scan(self, scan, tf_buffer, blocking: bool = True):
        """Process one decoded ``timestamps.Scan`` against a
        TransformBuffer: lazy init seeds the pose from wheel_odom->base
        and caches the base->lidar extrinsic; per frame, the
        wheel-odometry delta between scan stamps (the previous scan's end
        to this one's) is looked up, and the scan is registered by
        ``register_frame(..., blocking=blocking)``.  Returns the
        register_frame result dict (or None while initialization is
        pending)."""
        from .utils.io.timestamps import TimeStampHandler

        if self._stamps_handler is None:
            self._stamps_handler = TimeStampHandler()
        handler = self._stamps_handler
        cfg = self.server_config
        with profiling.span("kicp.tf_lookup"):
            if not self._initialized:
                if not (tf_buffer.frame_exists(cfg.wheel_odom_frame)
                        and tf_buffer.frame_exists(cfg.base_frame)
                        and tf_buffer.frame_exists(scan.frame_id)):
                    return None  # wait for tf, like cpp:141-145
                self.set_pose(tf_buffer.lookup_transform(
                    cfg.wheel_odom_frame, cfg.base_frame, scan.stamp))
                self.extrinsic = tf_buffer.lookup_transform(
                    cfg.base_frame, scan.frame_id, scan.stamp)
                handler.last_processed_stamp = scan.stamp
                self._initialized = True
            begin = handler.last_processed_stamp
            handler.last_processed_stamp = scan.end
            delta = tf_buffer.lookup_delta_transform(
                cfg.base_frame, begin, scan.end, cfg.wheel_odom_frame)
        return self.register_frame(scan.points, scan.timestamps, delta,
                                   stamp=scan.end, blocking=blocking)

    def make_odometry_message(self, result, stamp: float):
        """nav_msgs/Odometry with the parameterized fixed covariance
        (PublishOdometryMsg parity, LidarOdometryServer.cpp:144-157,220-238).

        Use with BLOCKING results (streaming results carry ``pose=None``
        until ``drain()``: call drain and read ``poses_with_stamps``).
        """
        from scipy.spatial.transform import Rotation

        from .utils.io.messages import Header, Odometry, Time

        cfg = self.server_config
        pose = result["pose"]
        cov = np.zeros(36)
        cov[0] = cov[7] = cfg.position_covariance
        cov[35] = cfg.orientation_covariance
        twist = result.get("twist")
        return Odometry(
            header=Header(Time.from_sec(stamp), cfg.lidar_odom_frame),
            child_frame_id=cfg.base_frame,
            position=pose[:3, 3].copy(),
            orientation=Rotation.from_matrix(pose[:3, :3]).as_quat(),
            pose_covariance=cov,
            twist_linear=(np.zeros(3) if twist is None else twist[:3]),
            twist_angular=(np.zeros(3) if twist is None else twist[3:]),
            twist_covariance=cov.copy())

    def make_tf_message(self, result, stamp: float):
        """The odometry tf edge, optionally inverted to satisfy tf's
        single-parent rule (LidarOdometryServer.cpp:105-123,130-142)."""
        from .utils.io.messages import TFMessage, TransformStamped

        cfg = self.server_config
        pose = result["pose"]
        if cfg.invert_odom_tf:
            t = TransformStamped.from_matrix(
                np.linalg.inv(pose), stamp, cfg.base_frame,
                cfg.lidar_odom_frame)
        else:
            t = TransformStamped.from_matrix(
                pose, stamp, cfg.lidar_odom_frame, cfg.base_frame)
        return TFMessage([t])

    # ------------------------------------------------------------------
    def write_tum(self, path):
        from .utils.io.tum import write_tum
        self.drain()
        write_tum(path, self.poses_with_stamps)
