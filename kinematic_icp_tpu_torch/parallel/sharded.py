"""Map-sharded + sequence-batched odometry over a (data, map) mesh.

The voxel hash map's buckets are partitioned over the ``map`` mesh axis
(ownership = the top bits of the KISS-ICP spatial hash, so bucket indexing
inside each shard keeps using the low bits of its own hash); independent
sequences are partitioned over the ``data`` axis.  A rank holds its
``batch // data`` sequences and, of each, ``map_capacity // map`` slots.
Per GN trip, on collectives over the map group (by the mesh's route,
``parallel.mesh.make_mesh``: the port's own all-reduce over peer memory,
``parallel.peer``, which a conditional graph node can hold; or the
group's own ``all_reduce``, NCCL's or gloo's):

  * every shard searches its local table for all query points (a voxel
    another shard owns is simply absent),
  * the winning shard per query is ONE (N,) int32 ``all_reduce(MIN)`` over
    packed (distance | shard) keys (``shard_keys``), and only it keeps the
    pair,
  * the 2-DoF normal equations (6 floats a sequence) reduce with one
    ``all_reduce(SUM)``; so do the residual sums of the adaptive β before
    the first trip, the final correspondence count and the map's insert
    failures,
  * the map insert and eviction stay shard-local (ownership-filtered).

The data axis never communicates inside a frame; the poses (and overflow
totals) are gathered over it once a step or a sequence.  On an NCCL mesh
the frame is captured as a CUDA graph, its collectives inside it, and
replayed every frame, as JAX runs its sharded step as one jitted dispatch;
gloo's collectives cannot be captured, so on gloo the frame runs eagerly.

JAX's data-dependent ``while`` loop is ``registration.run_gn``'s, as on
one device: in a captured frame each later trip, with its SUM, and each
re-association, with its MIN, sits inside a conditional graph node
(``utils.cuda_graph.when``), so the loop stops on the device where JAX's
stops and skips the re-associations JAX's ``lax.cond`` skips.  Every
predicate of those nodes is computed from reduced values only, so every
rank of a map group takes the same branch and issues the same collectives
in the same order (a branch on one rank's data would leave the other
ranks waiting in a collective).  Eagerly every trip runs, masked, and
issues its collectives.  On the "nccl" route the loop is not gated
(``run_gn(gated=False)``): NCCL's collectives cannot live in a
conditional body, so a captured frame runs every trip and every
re-association, masked, as the eager loop does, with the same bits.  The
GN kernel does not run here, by design, as in the JAX package
(``Config.gn_backend`` is ignored): each trip needs the cross-shard
minimum, which the GN kernel cannot take inside it.

``COLLECTIVES`` counts, on the host, the collectives a frame issues
outside the GN loop (the insert failures' SUM and the data-axis gathers);
a replay advances it by what its capture issued.  The loop's own (β's and
each trip's SUM, each association's MIN, the final correspondence SUM)
run inside and around its conditional nodes, where a replay cannot tell
the host whether they ran, and a production frame counts nothing there: a
caller that wants them counts them on the device by wrapping
``_all_reduce`` while ``registration.run_gn`` runs, as ``chip_smoke.py``'s
``device_counts`` counts the loop's associations.  A map group of one
rank on the "none" route reduces nothing (its ``_all_reduce`` returns its
input).

Three differences from the JAX package's sharded path, each a fault there:
the downsample honours ``Config.downsample_tiebreak``; the exact mode
re-gathers all 27 voxels on every association, as the reference and the
single-device exact modes do (JAX gathers ``neighbor_candidates``); and
the sequence runner takes its ``stationary_gate`` (JAX fixes 1e-3).  Like
JAX's, the exact mode has no certificate and no pruning here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import Config
from ..models import pipeline
from ..offline import STATIONARY_GATE, _runner, init_batched_state
from ..ops import hashmap, registration, se3, voxel
from ..ops.points import per_row, transform
from ..utils import cuda_graph
from . import mesh as _mesh

#: collectives issued so far outside the GN loop (a plain count, for
#: reading how many a frame takes; as ``gn.LAUNCHES`` counts kernel
#: launches)
COLLECTIVES = 0
cuda_graph.replayed(__name__, counters=("COLLECTIVES",))


class _Axes(NamedTuple):
    """This rank's place on the mesh."""
    data: int                 # ranks on the data axis
    map: int                  # ranks (shards) on the map axis
    d: int                    # this rank's data index
    j: int                    # this rank's shard index
    data_group: object
    map_group: object
    device: torch.device
    route: str                # the map axis's route (``make_mesh``)
    peers: object             # its ``peer.PeerGroup`` on the "peer" route


def _axes(mesh) -> _Axes:
    data, m = mesh.shape
    if m > 32:
        raise ValueError(f"{m} map shards: the packed keys hold a 5-bit "
                         f"shard index (shard_keys)")
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    return _Axes(data, m, mesh.get_local_rank("data"),
                 mesh.get_local_rank("map"), mesh.get_group("data"),
                 mesh.get_group("map"), dev, *_mesh.map_reduction(mesh))


def _all_reduce(t, op, axes: _Axes):
    """``t`` reduced in place over the map group (every rank gets the same
    bits), and returned, by the route of ``axes``: the port's kernel over
    peer memory (``parallel.peer``), which a conditional body can hold, on
    "peer"; ``t`` itself on "none"; the group's own ``all_reduce``
    otherwise."""
    if axes.route == "peer":
        axes.peers.all_reduce(t, op)
    elif axes.route != "none":
        dist.all_reduce(t, op=op, group=axes.map_group)
    return t


def _gather_rows(local, dim: int, axes: _Axes):
    """Every data rank's ``local`` rows, concatenated along ``dim`` in rank
    order (the whole batch, the same on every rank)."""
    global COLLECTIVES
    if axes.data == 1:
        return local
    COLLECTIVES += 1
    parts = [torch.empty_like(local) for _ in range(axes.data)]
    dist.all_gather(parts, local.contiguous(), group=axes.data_group)
    return torch.cat(parts, dim)


def _owner_of(bx, by, bz, num_shards: int):
    """Shard owning a voxel: the top ceil(log2 m) bits of the spatial hash
    (int64)."""
    if num_shards == 1:
        return torch.zeros(bx.shape, dtype=torch.int64, device=bx.device)
    shift = 32 - (num_shards - 1).bit_length()
    return voxel.spatial_hash_planar(bx, by, bz) >> shift


def shard_keys(dist_, shard: int):
    """Per-query int32 keys whose minimum over the shards is the winner.

    The shard index rides the 5 low mantissa bits of the float32 distance
    (non-negative floats order as integers; the sign bit is clear even for
    the +inf no-candidate sentinel, so a signed minimum works).  Ties after
    masking (equal to 2^-18 relative) go to the lowest shard; the tau gate
    uses each winner's own full-precision distance."""
    return (dist_.to(torch.float32).view(torch.int32) & ~31) | shard


def _mine(dist_, axes: _Axes):
    """The queries whose nearest neighbour is on this shard."""
    keys = shard_keys(dist_, axes.j)
    best = _all_reduce(keys.clone(), dist.ReduceOp.MIN, axes)
    return keys == best


def _sharded_robot_motion(local_map, source, source_mask, last_pose,
                          relative_odometry, tau, config: Config,
                          axes: _Axes):
    """ComputeRobotMotion (Registration.cpp:151-190) with map-axis
    collectives."""
    guess = se3.compose44(last_pose, relative_odometry)
    tau = per_row(torch.as_tensor(tau, dtype=source.x.dtype,
                                  device=source.x.device))

    if config.exact_gn_reassociation:
        def nearest(pose):
            return hashmap.nearest_neighbor(
                local_map, transform(pose, source), source_mask,
                config.voxel_size, config.max_probes, 27)
    else:
        # one gather pass a frame against this shard's slots; the trips
        # re-select among the cached candidates
        world_guess = transform(guess, source)
        cand = hashmap.gather_candidates(
            local_map, world_guess, config.voxel_size, config.max_probes,
            config.neighbor_candidates)
        if config.gn_candidates_per_voxel:
            cand = hashmap.reduce_candidates(
                cand, world_guess, config.gn_candidates_per_voxel,
                config.voxel_size)

        def nearest(pose):
            return hashmap.nn_from_candidates(
                cand, transform(pose, source), source_mask,
                config.voxel_size)

    def associate(pose):
        targets, d = nearest(pose)
        return targets, source_mask & (d < tau) & _mine(d, axes), None

    pose, iters, ncorr, _ = registration.run_gn(
        associate, source, guess,
        max_num_iterations=config.max_num_iterations,
        convergence_criterion=config.convergence_criterion,
        use_adaptive_odometry_regularization=(
            config.use_adaptive_odometry_regularization),
        fixed_regularization=config.fixed_regularization,
        reduce=lambda sums: _all_reduce(sums, dist.ReduceOp.SUM, axes),
        gated=axes.route != "nccl")
    return pose, registration.RegistrationDebug(iterations=iters,
                                                num_correspondences=ncorr)


def _update_shard(m, frame_ds, frame_ds_mask, pose, config: Config,
                  axes: _Axes, active):
    """VoxelHashMap::Update on this shard: insert the voxels it owns, evict
    its far blocks.  Returns (map, this shard's insert failures)."""
    world = transform(pose, frame_ds)
    owner = _owner_of(*voxel.voxel_coords_planar(world, config.voxel_size),
                      axes.map)
    return hashmap.update(
        m, frame_ds, frame_ds_mask & (owner == axes.j), pose,
        config.voxel_size, config.max_range, config.max_probes,
        enable=active, max_extent=2.0 * config.max_range, return_failed=True)


def sharded_register_frame(state: pipeline.OdometryState, points, timestamps,
                           mask, has_timestamps, lidar_to_base,
                           relative_odometry, config: Config, mesh,
                           active=None, rel_twist_in_lidar=None):
    """One odometry step of this rank's sequences on its map shard.

    ``state`` is this rank's (``init_sharded_state``): its rows, and of each
    map its ``config.map_capacity // map`` slots; every other input has the
    same rows and is the same on every shard of the map axis (preprocessing
    and downsampling run identically on each).  Arguments and outputs are
    ``pipeline.register_frame``'s; ``outputs.overflow``'s insert failures
    are summed over the shards, its downsample drops are each shard's own
    (they are the same).  ``active`` False (the stationary gate) leaves a
    sequence's state as it was: the map update is write-masked.
    """
    global COLLECTIVES
    axes = _axes(mesh)
    prep = pipeline.prepare_frame(state, points, timestamps, mask,
                                  has_timestamps, lidar_to_base,
                                  relative_odometry, config,
                                  rel_twist_in_lidar)
    new_pose, debug = _sharded_robot_motion(
        state.map, prep.source, prep.source_mask, state.pose,
        relative_odometry, prep.tau, config, axes)
    new_map, failed = _update_shard(state.map, prep.frame_ds,
                                    prep.frame_ds_mask, new_pose, config,
                                    axes, active)
    COLLECTIVES += 1
    failed = _all_reduce(failed, dist.ReduceOp.SUM, axes)
    return pipeline.finish_frame(state, prep, relative_odometry, new_pose,
                                 debug, new_map, failed, config, active)


# ----------------------------------------------------------------------
# Batched + sharded steps over a (data, map) mesh
# ----------------------------------------------------------------------

def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    return _axes(mesh).device


def init_sharded_state(config: Config, mesh, batch: int,
                       dtype=torch.float32) -> pipeline.OdometryState:
    """This rank's part of a fresh batched state of ``batch`` sequences:
    pose (B_l, 4, 4), bucket table (B_l, NB / map, G*R) and threshold
    accumulators (B_l,), B_l = ``batch // data``, on the rank's device.
    JAX's ``P('data', 'map')`` layout: rank (d, j) holds rows
    ``d*B_l:(d+1)*B_l`` and buckets ``j*NB/map:(j+1)*NB/map`` of the whole
    (B, NB, G*R) table."""
    axes = _axes(mesh)
    if config.map_capacity % (axes.map * config.max_probes):
        raise ValueError(f"map_capacity {config.map_capacity} does not split "
                         f"into {axes.map} shards of {config.max_probes}-slot "
                         f"buckets")
    if batch % axes.data:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{axes.data} data ranks")
    local = config.replace(map_capacity=config.map_capacity // axes.map)
    return init_batched_state(local, batch // axes.data, dtype, axes.device)


def _rows(axes: _Axes, state, batch: int):
    """This rank's slice of a whole batch of ``batch`` rows."""
    local = state.pose.shape[0]
    if local * axes.data != batch:
        raise ValueError(f"a batch of {batch} sequences for a state of "
                         f"{local} rows on each of {axes.data} data ranks")
    return slice(axes.d * local, (axes.d + 1) * local)


def _local(rows: slice, frame):
    """This rank's rows of a frame's whole-batch inputs (the batch axis
    first)."""
    return tuple(a[rows] for a in frame)


def make_sharded_step(config: Config, mesh):
    """The batched step over the (data, map) mesh: ``step(state, points
    (B, N, 3), timestamps (B, N), mask (B, N), has_timestamps (B,),
    lidar_to_base (4, 4), relative_odometry (B, 4, 4), active (B,)) ->
    (state, poses (B, 4, 4), overflow (B, 3))``.

    Every rank passes the whole batch and takes its own rows; ``state`` is
    the rank's (``init_sharded_state``) and comes back as the rank's, the
    poses and overflow counts gathered over the data axis (the same on
    every rank).  ``active`` False (the stationary gate) keeps a sequence's
    state.

    The frame runs over the step's own buffers (``pipeline.Step``, with
    ``sharded_register_frame``): the state returned is the step's, valid
    until its next call, and the caller's old state must not be used again
    (JAX's ``donate=True``); on a data axis of one rank the poses and
    overflow are the step's too.  Where the map group is NCCL's the frame
    is captured as a CUDA graph at its first call of each static shape and
    replayed every frame, its collectives inside the graph, with no host
    sync: on the "peer" and "none" routes the GN loop's later trips and
    re-associations inside conditional nodes (a replay makes JAX's trips),
    on the "nccl" route every trip, masked, outside any; on gloo, whose
    collectives a CUDA graph cannot hold, or on the CPU, the same frame
    runs eagerly over the same buffers, every trip.  The gathers over the
    data axis run outside the frame.  A captured frame refers to the map
    group's communicator or peer regions: leave the group with
    ``parallel.shutdown_distributed``, which frees the graphs first.
    """
    axes = _axes(mesh)
    frame = _frame_step(config, mesh, axes)

    def step(state, points, timestamps, mask, has_timestamps, lidar_to_base,
             relative_odometry, active):
        rows = _rows(axes, state, points.shape[0])
        state, out = frame(
            state, *_local(rows, (points, timestamps, mask, has_timestamps)),
            lidar_to_base, relative_odometry[rows], active=active[rows])
        return (state, _gather_rows(out.pose, 0, axes),
                _gather_rows(out.overflow, 0, axes))

    return step


def _frame_step(config: Config, mesh, axes: _Axes) -> pipeline.Step:
    """``sharded_register_frame`` over buffers of its own, captured where
    the map group's backend is NCCL (chosen by the backend, never by
    trying a capture); a captured step's graphs are freed by
    ``parallel.shutdown_distributed``."""
    step = pipeline.Step(
        config, device=axes.device,
        register=functools.partial(sharded_register_frame, mesh=mesh),
        capture=dist.get_backend(axes.map_group) == "nccl")
    if step.capture:
        _mesh.track_captured(step)
    return step


def make_sharded_sequence_runner(config: Config, mesh,
                                 stationary_gate: float = STATIONARY_GATE,
                                 eager: bool = False):
    """Whole sequences over the (data, map) mesh: ``run(state, pts (F, B,
    N, 3), ts (F, B, N), mask (F, B, N), has_ts (F, B), lidar_to_base (4,
    4), rels (F, B, 4, 4)) -> (state, poses (F, B, 4, 4), overflow (B,
    3), fallbacks (B,), counts (B, 5))``, as the batched runner returns
    them (no fallbacks: the sharded frame has no certificate).
    ``run(state, frames, lidar_to_base, rels)`` takes the frames one at a
    time instead, as ``offline.make_batched_sequence_runner``'s does: each
    batched frame's whole-batch ``(points (B, N, 3), timestamps (B, N),
    mask (B, N), has_ts (B,))``, asked for after the frame before was
    issued (``BatchedOdometryRunner.run_device``'s ring).

    The frame loop of ``offline.make_batched_sequence_runner`` on the
    rank's rows, with the stationary gate (|log(rel)| above
    ``stationary_gate``) and the deskew twist computed for all frames
    before it (``offline._per_frame_constants``): identity padding is a
    stationary frame.  Returns the rank's state, and the poses and
    per-sequence totals of the whole batch, gathered over the data axis.
    Each frame runs as ``make_sharded_step``'s does: one replay of a CUDA
    graph a frame where the map group is NCCL's, the same frame eagerly
    over the same buffers on gloo or the CPU; the state is copied out at
    the end.  ``eager=True`` runs
    ``sharded_register_frame`` op by op (the baseline a replay is held to:
    every GN trip, where a replay makes JAX's).
    """
    axes = _axes(mesh)

    register = (functools.partial(sharded_register_frame, config=config,
                                  mesh=mesh) if eager
                else _frame_step(config, mesh, axes))
    loop = _runner(config, axes.device, stationary_gate, batched=True,
                   register=register)

    def run(state, *inputs):
        *frames, lidar_to_base, rels = inputs
        if len(frames) == 4:  # padded (F, B, N, ...) tensors
            rows = _rows(axes, state, frames[0].shape[1])
            frames = [a[:, rows] for a in frames]
        else:  # a source of each frame's whole-batch inputs, in order
            rows = _rows(axes, state, rels.shape[1])
            frames = [(_local(rows, f) for f in frames[0])]
        state, poses, overflow, _, counts = loop(
            state, *frames, lidar_to_base, rels[:, rows])
        # one gather of both per-sequence tallies
        _, counts, overflow = pipeline.unpack_tallies(_gather_rows(
            pipeline.pack_tallies(counts, overflow), 0, axes))
        fallbacks = counts[:, pipeline.COUNTS.index("exact_fallback_frames")]
        return (state, _gather_rows(poses, 1, axes), overflow, fallbacks,
                counts)

    #: the runner's ``pipeline.Step`` (its graphs), or None on the eager loop
    run.step = loop.step
    return run
