"""The per-frame odometry pipeline (``KinematicICP`` in PyTorch).

Functional equivalent of ``kinematic_icp::pipeline::KinematicICP``
(KinematicICP.{hpp,cpp}): the C++ class's mutable members (pose, voxel map,
threshold accumulators) become an explicit ``OdometryState``, and
``RegisterFrame`` becomes ``register_frame(state, inputs) -> (state',
outputs)``.  ``register_frame`` is ``prepare_frame``, the registration and
map update, then ``finish_frame``; the map-sharded step
(``parallel.sharded``) runs the same first and last parts around its own
middle.

``make_step`` is the counterpart of the JAX package's jitted, donated step:
a ``Step`` keeps the state and the inputs in buffers of its own, and on a
CUDA device runs the frame as replays of CUDA graphs captured once per
static shape (``utils.cuda_graph``), for every configuration: one replay
a frame that reads nothing back.  Where JAX's frame runs a ``lax.cond``
(the certified and pruned exact modes' full-27 fallback) or a
``lax.while_loop`` (the GN loop lowering), the graph holds conditional
nodes that decide on the device.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import hashmap, preprocessing, registration, se3, threshold, voxel
from ..ops.points import P3, per_row, transform
from ..runtime import resolve_device
from ..utils import profiling
from ..utils.cuda_graph import StaticCall, refill


class OdometryState(NamedTuple):
    """The state one sequence carries between frames; a batch of B
    sequences puts B before every tensor (pose (B, 4, 4), table (B, NB,
    G*R), accumulators (B,))."""
    pose: torch.Tensor                   # (4, 4) — last_pose_
    map: hashmap.MapState                # local_map_
    threshold: threshold.ThresholdState  # correspondence_threshold_


class FrameOutputs(NamedTuple):
    """Per-frame outputs, mirroring the reference's return + debug topics
    (each with a leading B in a batch)."""
    frame: P3                   # (N,) planes — deskewed frame in base coords
    frame_mask: torch.Tensor    # (N,)
    source: P3                  # (S,) planes — ICP keypoints (base frame)
    source_mask: torch.Tensor   # (S,)
    pose: torch.Tensor          # (4, 4) new pose
    debug: registration.RegistrationDebug
    #: (3,) int32 capacity-overflow counters [downsample voxels dropped,
    #: source voxels dropped, map insert bucket-overflow voxels]; nonzero
    #: means the static capacities are undersized; (B, 3) in a batch
    overflow: torch.Tensor
    #: (5,) int32 counts of the frame, ``COUNTS``' columns: 1 (the
    #: frame registered), the GN passes of its first solve (the kernel's,
    #: without the full-27 fallback loop's trips), its live sources, 1
    #: where an exact mode's certificate failed and the full-27 loop
    #: re-solved it, and that loop's trips there (``debug.iterations``; 0
    #: where the frame did not fall back); zeros where the stationary gate
    #: held the frame; (B, 5) in a batch
    counts: torch.Tensor


#: the columns of ``FrameOutputs.counts``, and the keys of the operator's
#: totals of them (``LidarOdometryServer.frame_stats``,
#: ``BatchedOdometryRunner.stats``)
COUNTS = ("frames", "gn_passes", "gn_sources", "exact_fallback_frames",
          "exact_fallback_trips")
#: the columns of ``FrameOutputs.overflow``, and the keys of the operator's
#: totals of them (``LidarOdometryServer.overflow_stats``)
OVERFLOW = ("downsample_dropped", "source_dropped", "insert_failed")


def pack_tallies(counts, overflow, head=()):
    """One int32 row of ``head``'s words, then counts (..., 5) and
    overflow totals (..., 3), for one transfer (``unpack_tallies``)."""
    return torch.cat([*head, counts, overflow], -1)


def unpack_tallies(rows):
    """``pack_tallies``' rows (torch or numpy) -> (the head's words,
    counts (..., 5), overflow (..., 3))."""
    o = rows.shape[-1] - len(OVERFLOW)
    c = o - len(COUNTS)
    return rows[..., :c], rows[..., c:o], rows[..., o:]


def add_counts(totals: dict, counts) -> None:
    """Add read-back counts (..., 5) (``COUNTS``' columns; a frame's, or
    one row a sequence) to an operator's ``totals`` keyed by ``COUNTS``
    (ints, or arrays of the rows' shape), and their sums to the trace's
    ``gn`` counter while recording."""
    counts = np.asarray(counts, np.int64)
    for key, column in zip(COUNTS, np.moveaxis(counts, -1, 0).tolist()):
        totals[key] += column
    s = dict(zip(COUNTS, counts.reshape(-1, len(COUNTS)).sum(0).tolist()))
    profiling.count("gn", frames=s["frames"], passes=s["gn_passes"],
                    sources=s["gn_sources"],
                    fallbacks=s["exact_fallback_frames"],
                    fallback_trips=s["exact_fallback_trips"])


def init_state(config: Config, dtype=torch.float32, initial_pose=None,
               device=None) -> OdometryState:
    """Fresh state on ``device`` (``None`` = CUDA; raises if absent)."""
    dev = resolve_device(device)
    pose = (torch.eye(4, dtype=dtype, device=dev) if initial_pose is None
            else torch.as_tensor(initial_pose, dtype=dtype, device=dev))
    return OdometryState(
        pose=pose,
        map=hashmap.empty(config.map_capacity, config.max_points_per_voxel,
                          bucket_slots=config.max_probes, device=dev),
        threshold=threshold.init_state(dtype, dev),
    )


def set_pose(state: OdometryState, pose, config: Config) -> OdometryState:
    """SetPose: reset pose, clear map and threshold (KinematicICP.hpp:86-90)."""
    del config
    return OdometryState(
        pose=torch.as_tensor(pose, dtype=state.pose.dtype,
                             device=state.pose.device),
        map=hashmap.clear(state.map),
        threshold=threshold.init_state(state.pose.dtype, state.pose.device),
    )


class PreparedFrame(NamedTuple):
    """A frame up to its registration (each with a leading B in a batch)."""
    frame: P3                   # (N,) planes — deskewed frame in base coords
    frame_mask: torch.Tensor    # (N,)
    source: P3                  # (S,) planes — ICP keypoints (base frame)
    source_mask: torch.Tensor   # (S,)
    frame_ds: P3                # (D,) planes — the map-update cloud
    frame_ds_mask: torch.Tensor  # (D,)
    ds_dropped: torch.Tensor    # (2,) int32 downsample capacity overflows
    tau: torch.Tensor           # correspondence threshold


def register_frame(state: OdometryState, points, timestamps, mask,
                   has_timestamps, lidar_to_base, relative_odometry,
                   config: Config, active=None, rel_twist_in_lidar=None
                   ) -> tuple[OdometryState, FrameOutputs]:
    """One odometry step (KinematicICP.cpp:48-85).

    With a batched ``state`` (``offline.init_batched_state``) every per-frame
    input gains the same leading B axis (points (B, N, 3), ``active`` and
    ``has_timestamps`` (B,), odometry (B, 4, 4); ``lidar_to_base`` stays
    one shared (4, 4)) and B sequences advance by one frame each, in the
    launches of one frame.

    Args:
      state: current odometry state.
      points: (N, 3) raw scan in the lidar frame (padded).
      timestamps: (N,) per-point times normalized to [0, 1].
      mask: (N,) validity of the padded rows.
      has_timestamps: scalar bool tensor; a missing timestamp field
        disables deskew.
      lidar_to_base: (4, 4) extrinsic.
      relative_odometry: (4, 4) wheel-odometry delta in the base frame.
      active: optional scalar bool, the stationary gate; when False the
        returned state equals the input.
      rel_twist_in_lidar: optional precomputed (6,)
        ``se3_log(lidar_to_base^-1 @ relative_odometry @ lidar_to_base)``.
    """
    prep = prepare_frame(state, points, timestamps, mask, has_timestamps,
                         lidar_to_base, relative_odometry, config,
                         rel_twist_in_lidar)
    new_pose, debug = registration.compute_robot_motion(
        state.map, prep.source, prep.source_mask, state.pose,
        relative_odometry, prep.tau,
        voxel_size=config.voxel_size, max_probes=config.max_probes,
        max_num_iterations=config.max_num_iterations,
        convergence_criterion=config.convergence_criterion,
        use_adaptive_odometry_regularization=(
            config.use_adaptive_odometry_regularization),
        fixed_regularization=config.fixed_regularization,
        num_candidate_voxels=config.neighbor_candidates,
        exact_gn_reassociation=config.exact_gn_reassociation,
        exact_prune_candidates=config.exact_prune_candidates,
        gn_candidates_per_voxel=config.gn_candidates_per_voxel,
        gn_backend=config.gn_backend,
        threshold_max_range=config.max_range)
    new_map, insert_failed = hashmap.update(
        state.map, prep.frame_ds, prep.frame_ds_mask, new_pose,
        config.voxel_size, config.max_range, config.max_probes,
        enable=active, max_extent=2.0 * config.max_range,
        return_failed=True)
    return finish_frame(state, prep, relative_odometry, new_pose, debug,
                        new_map, insert_failed, config, active)


def prepare_frame(state: OdometryState, points, timestamps, mask,
                  has_timestamps, lidar_to_base, relative_odometry,
                  config: Config, rel_twist_in_lidar=None) -> PreparedFrame:
    """A frame's steps before its registration (``register_frame``'s
    arguments): deskew and range filter, the double downsample and the
    correspondence threshold."""
    dtype = state.pose.dtype
    p = P3.from_array(points).astype(dtype)

    if config.deskew:
        if rel_twist_in_lidar is None:
            # Deskew in the lidar frame (KinematicICP.cpp:53-55).
            ext = lidar_to_base.expand(relative_odometry.shape)
            rel_odom_in_lidar = se3.compose44(
                se3.compose44(se3.inverse(ext), relative_odometry), ext)
            rel_twist_in_lidar = se3.se3_log(rel_odom_in_lidar)
        frame, frame_mask = preprocessing.preprocess(
            p, timestamps, mask, None,
            min_range=config.min_range, max_range=config.max_range,
            deskew_enabled=True, has_timestamps=has_timestamps,
            twist=rel_twist_in_lidar)
    else:
        frame = p
        frame_mask = preprocessing.range_filter_mask(
            p, mask, config.min_range, config.max_range)

    frame_in_base = transform(lidar_to_base, frame)

    source, source_mask, frame_ds, frame_ds_mask, ds_dropped = \
        voxel.double_downsample(
            frame_in_base, frame_mask, config.voxel_size,
            max_downsampled=config.max_downsampled,
            max_source=config.max_source, max_extent=2.0 * config.max_range,
            tiebreak=config.downsample_tiebreak)

    tau = threshold.compute_threshold(
        state.threshold,
        map_discretization_error=config.map_resolution(),
        use_adaptive=config.use_adaptive_threshold,
        fixed_threshold=config.fixed_threshold)
    return PreparedFrame(frame_in_base, frame_mask, source, source_mask,
                         frame_ds, frame_ds_mask, ds_dropped, tau)


def finish_frame(state: OdometryState, prep: PreparedFrame,
                 relative_odometry, new_pose, debug, new_map, insert_failed,
                 config: Config, active=None
                 ) -> tuple[OdometryState, FrameOutputs]:
    """A frame's steps after its registration and map update: the
    threshold update, the stationary gate (``active`` False keeps the
    state's pose and threshold; the map update takes it as ``enable``) and
    the outputs."""
    if debug.odometry_error_pt is not None:
        # The kernel branches return the point-space error of
        # guess^-1 @ new_pose (KinematicICP.cpp:75 +
        # CorrespondenceThreshold.cpp:37-44).
        new_threshold = threshold.update_odometry_error_scalar(
            state.threshold, debug.odometry_error_pt,
            use_adaptive=config.use_adaptive_threshold)
    else:
        # odometry_error = (last * rel_odom)^-1 * new (KinematicICP.cpp:75)
        prediction = se3.compose44(state.pose, relative_odometry)
        odometry_error = se3.compose44(se3.inverse(prediction), new_pose)
        new_threshold = threshold.update_odometry_error(
            state.threshold, odometry_error, max_range=config.max_range,
            use_adaptive=config.use_adaptive_threshold)

    if active is not None:
        new_pose = torch.where(per_row(active, 2), new_pose, state.pose)
        new_threshold = threshold.ThresholdState(
            *(torch.where(active, a, b)
              for a, b in zip(new_threshold, state.threshold)))

    new_state = OdometryState(pose=new_pose, map=new_map,
                              threshold=new_threshold)
    passes = (debug.iterations if debug.solve_iterations is None
              else debug.solve_iterations).to(torch.int32)
    fell = (torch.zeros_like(passes) if debug.exact_fallback is None
            else debug.exact_fallback.to(torch.int32))
    trips = fell * debug.iterations.to(torch.int32)
    counts = torch.stack([torch.ones_like(passes), passes,
                          prep.source_mask.sum(-1, dtype=torch.int32), fell,
                          trips], dim=-1)
    if active is not None:
        counts = counts * active[..., None]
    outputs = FrameOutputs(
        frame=prep.frame, frame_mask=prep.frame_mask,
        source=prep.source, source_mask=prep.source_mask,
        pose=new_pose, debug=debug,
        overflow=torch.cat([prep.ds_dropped, insert_failed[..., None]],
                           dim=-1).to(torch.int32),
        counts=counts)
    return new_state, outputs


def _tree_map(fn, tree):
    """``fn`` on every tensor of a state or an outputs tuple."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, hashmap.MapState):
        return hashmap.MapState(fn(tree.table), tree.bucket_slots)
    return type(tree)(*(_tree_map(fn, t) for t in tree))


def clone_state(state: OdometryState) -> OdometryState:
    """A copy of ``state`` in tensors of its own."""
    return _tree_map(torch.clone, state)


def state_tensors(state: OdometryState):
    """The state's tensors, flat: pose, table, the two threshold sums."""
    return (state.pose, state.map.table, *state.threshold)


def state_of(tensors, bucket_slots: int) -> OdometryState:
    """The state of ``state_tensors``' four tensors."""
    pose, table, sse, n = tensors
    return OdometryState(pose, hashmap.MapState(table, bucket_slots),
                         threshold.ThresholdState(sse, n))


class _Frame:
    """A step's buffers and call for one static shape."""

    def __init__(self, step: "Step", state: OdometryState, inputs):
        slots = state.map.bucket_slots
        self.state = state_of(tuple(torch.empty_like(t) for t in
                                     state_tensors(state)), slots)
        self.inputs = tuple(None if x is None else torch.zeros_like(x)
                            for x in inputs)
        #: (weak reference, version) of the tensor each input buffer last
        #: took, so an unchanged input (the extrinsic) is not copied again
        self._sources = [None] * len(inputs)
        present = [i for i, x in enumerate(inputs) if x is not None]
        config = step.config

        def frame(*buffers):
            state_in = state_of(buffers[:4], slots)
            args = [None] * len(inputs)
            for i, b in zip(present, buffers[4:]):
                args[i] = b
            new_state, out = step.register(
                state_in, *args[:6], config, active=args[6],
                rel_twist_in_lidar=args[7])
            refill(buffers[:4], state_tensors(new_state))
            return out

        self.call = StaticCall(
            frame, (*state_tensors(self.state),
                    *(self.inputs[i] for i in present)),
            capture=step.capture, pool=step.pool)

    def load(self, state: OdometryState):
        if state is not self.state:
            refill(state_tensors(self.state), state_tensors(state))

    def fill(self, inputs):
        for i, (buf, src) in enumerate(zip(self.inputs, inputs)):
            if buf is None:
                continue
            last = self._sources[i]
            if last is not None and last[0]() is src \
                    and last[1] == src._version:
                continue
            buf.copy_(src)
            self._sources[i] = (weakref.ref(src), src._version)


class Step:
    """``register_frame`` under ``config`` over buffers of its own: the
    counterpart of the JAX package's jitted, donated step.

    ``step(state, points, timestamps, mask, has_timestamps, lidar_to_base,
    relative_odometry, active=None, rel_twist_in_lidar=None) -> (state,
    outputs)`` takes ``register_frame``'s arguments (every per-frame value
    a tensor on the step's device; a batched state and inputs as
    ``register_frame`` takes them).  The first call of each static shape
    (dtype, batch, point capacity, which optional inputs are given)
    allocates the buffers; every call copies the state in (unless it is
    the state the step last returned) and each input that changed, then
    runs the frame over the buffers, writing the new state back into them.
    On a CUDA device the frame is captured at that first call as a CUDA
    graph and every call replays it: one replay with no host sync, under
    every mode (``utils.cuda_graph``); on the CPU it runs eagerly over the
    same buffers.

    ``donate=True`` returns the step's own state (and on a card its
    outputs): they hold this frame until the step's next call with the
    same shapes, and the caller's old state must not be used again (JAX's
    donation).
    ``donate=False`` returns clones and leaves the input state as it was.
    ``register`` (``register_frame``'s arguments) is the frame, and
    ``capture`` (default: on a CUDA device) whether it runs as graphs: the
    map-sharded step passes its own frame and captures only where its
    collectives can be captured (``parallel.sharded``).
    """

    def __init__(self, config: Config, donate: bool = True, device=None,
                 register=register_frame, capture: bool | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.donate = donate
        self.register = register
        self.capture = (self.device.type == "cuda" if capture is None
                        else capture)
        #: the memory pool the step's graphs share (None without capture)
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._frames: dict[tuple, _Frame] = {}

    @property
    def calls(self) -> list[StaticCall]:
        """The step's static calls, one a static shape seen so far."""
        return [f.call for f in self._frames.values()]

    def release(self):
        """Free the graphs of every static shape now (each captures again
        at its next call, into a new memory pool: PyTorch refuses a capture
        into a pool whose graphs are all freed); the buffers stay."""
        for call in self.calls:
            call.release()
        if self.capture:
            self.pool = torch.cuda.graph_pool_handle()
            for call in self.calls:
                call.pool = self.pool

    def _frame_for(self, state: OdometryState, inputs) -> _Frame:
        """The buffers and call of this state's and inputs' static shape
        (built at its first use)."""
        key = (state.map.bucket_slots,
               *((t.dtype, tuple(t.shape)) for t in state_tensors(state)),
               *(None if x is None else (x.dtype, tuple(x.shape))
                 for x in inputs))
        frame = self._frames.get(key)
        if frame is None:
            for t in (*state_tensors(state),
                      *(x for x in inputs if x is not None)):
                if t.device.type != self.device.type:
                    raise ValueError(f"step on {self.device}: got a tensor "
                                     f"on {t.device}")
            frame = self._frames[key] = _Frame(self, state, inputs)
        return frame

    def __call__(self, state: OdometryState, points, timestamps, mask,
                 has_timestamps, lidar_to_base, relative_odometry,
                 active=None, rel_twist_in_lidar=None
                 ) -> tuple[OdometryState, FrameOutputs]:
        inputs = tuple(
            x if x is None or torch.is_tensor(x)
            else torch.as_tensor(x, device=self.device)
            for x in (points, timestamps, mask, has_timestamps, lidar_to_base,
                      relative_odometry, active, rel_twist_in_lidar))
        frame = self._frame_for(state, inputs)
        frame.load(state)
        frame.fill(inputs)
        out = frame.call()
        if self.donate:
            return frame.state, out
        return clone_state(frame.state), _tree_map(torch.clone, out)


@functools.lru_cache(maxsize=32)
def _cached_step(config: Config, donate: bool, device: torch.device) -> Step:
    return Step(config, donate, device)


def make_step(config: Config, donate: bool = True, device=None) -> Step:
    """The step of ``config`` on ``device`` (``None`` = CUDA; raises if
    absent): a ``Step``, cached per (config, donate, device) as JAX's
    ``make_step`` is, each holding one captured graph per static shape.

    The cached step is shared by every caller with the same arguments, so
    with ``donate=True`` the returned state is valid until the next call
    of that step; a caller that keeps state of its own between calls builds
    its own ``Step`` (the runners, the batched runner and the server do).
    """
    return _cached_step(config, donate, resolve_device(device))
