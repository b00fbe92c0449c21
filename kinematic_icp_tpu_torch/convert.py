"""Carry odometry state across packages as numpy arrays.

The state the system carries between frames (its "weights") is the pose,
the packed voxel map table and the adaptive-threshold accumulators.  Given
as numpy arrays (e.g. from the JAX package's ``OdometryState``), they
become this package's state, and back.  The table's u32 words are stored as
int32 bits, so the round trip is bit-exact.  A batched state (the batched
sequence runner's, or JAX's ``init_batched_state``) carries the same arrays
with a leading batch axis; a map-sharded state is one slice of such a
batched state a rank (``sharded_state_from_jax`` and its inverse).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.pipeline import OdometryState
from .ops.hashmap import MapState
from .ops.threshold import ThresholdState
from .runtime import resolve_device


def state_from_numpy(pose, table, odom_sse, num_samples, *, bucket_slots: int,
                     device=None, dtype=torch.float32) -> OdometryState:
    """(4, 4) pose, (NB, G*R) uint32 table, scalar accumulators -> state;
    or (B, 4, 4) poses, a (B, NB, G*R) table and (B,) accumulators -> a
    batched state.

    ``bucket_slots`` (G, ``Config.max_probes``) splits the table rows into
    slots; ``device`` ``None`` means CUDA (raises if absent); ``dtype`` is
    the pose's and the accumulators' (the state's float type).
    """
    dev = resolve_device(device)
    table = np.ascontiguousarray(table)
    if table.dtype != np.uint32 or table.ndim not in (2, 3):
        raise ValueError(f"table must be a 2-D (or batched 3-D) uint32 "
                         f"array, got {table.dtype} {table.shape}")
    if table.shape[-1] % bucket_slots:
        raise ValueError(f"table rows of {table.shape[-1]} lanes do not "
                         f"split into {bucket_slots} slots")
    lead = table.shape[:-2]
    pose = np.asarray(pose)
    if pose.shape != lead + (4, 4):
        raise ValueError(f"pose of shape {pose.shape} for a table of shape "
                         f"{table.shape}")

    def per_sequence(x):
        x = np.asarray(x)
        if x.shape != lead:
            raise ValueError(f"accumulator of shape {x.shape} for a table "
                             f"of shape {table.shape}")
        return torch.tensor(x, dtype=dtype, device=dev)

    return OdometryState(
        pose=torch.tensor(pose, dtype=dtype, device=dev),
        map=MapState(table=torch.from_numpy(table.view(np.int32).copy()
                                            ).to(dev),
                     bucket_slots=bucket_slots),
        threshold=ThresholdState(odom_sse=per_sequence(odom_sse),
                                 num_samples=per_sequence(num_samples)),
    )


def state_to_numpy(state: OdometryState):
    """State -> (pose (4, 4), table (NB, G*R) uint32, odom_sse,
    num_samples) numpy arrays, each with the leading B of a batched
    state."""
    return (state.pose.detach().cpu().numpy(),
            state.map.table.detach().cpu().numpy().view(np.uint32),
            state.threshold.odom_sse.detach().cpu().numpy(),
            state.threshold.num_samples.detach().cpu().numpy())


def sharded_state_from_jax(np_state, data: int, map: int, rank: int):
    """A whole batched state's arrays -> rank ``rank``'s slice of them on a
    (data, map) mesh, as ``state_to_numpy`` orders them.

    ``np_state``: (pose (B, 4, 4), table (B, NB, G*R) uint32, odom_sse (B,),
    num_samples (B,)), e.g. the JAX package's ``init_sharded_state`` or
    sharded runner's state read back whole.  Rank (d, j) (``rank = d * map
    + j``, the mesh's row-major order) takes rows ``d*B_l:(d+1)*B_l`` and
    buckets ``j*NB/map:(j+1)*NB/map``, JAX's ``P('data', 'map')`` layout;
    ``state_from_numpy`` makes the rank's state of them."""
    pose, table = np.asarray(np_state[0]), np.asarray(np_state[1])
    b, nb = table.shape[:2]
    if b % data or nb % map or not 0 <= rank < data * map:
        raise ValueError(f"a table of {b} rows and {nb} buckets on a "
                         f"{data}x{map} mesh, rank {rank}")
    d, j = divmod(rank, map)
    rows = slice(d * b // data, (d + 1) * b // data)
    buckets = slice(j * nb // map, (j + 1) * nb // map)
    return (pose[rows], np.ascontiguousarray(table[rows, buckets]),
            *(np.asarray(a)[rows] for a in np_state[2:]))


def sharded_state_to_jax(rank_arrays, data: int, map: int):
    """The inverse of ``sharded_state_from_jax``: every rank's arrays (a
    list in rank order, each as ``state_to_numpy`` returns them) -> the
    whole batched state's arrays.  The pose and accumulators of the map
    ranks of a data row are the same; the first's are taken."""
    if len(rank_arrays) != data * map:
        raise ValueError(f"{len(rank_arrays)} ranks for a {data}x{map} mesh")
    rows = [rank_arrays[d * map:(d + 1) * map] for d in range(data)]
    table = np.concatenate([np.concatenate([r[1] for r in row], axis=1)
                            for row in rows])
    return (np.concatenate([row[0][0] for row in rows]), table,
            *(np.concatenate([row[0][i] for row in rows]) for i in (2, 3)))
