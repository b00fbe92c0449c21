"""Carry odometry state across packages as numpy arrays.

The state the system carries between frames (its "weights") is the pose,
the packed voxel map table and the adaptive-threshold accumulators.  Given
as numpy arrays (e.g. from the JAX package's ``OdometryState``), they
become this package's state, and back.  The table's u32 words are stored as
int32 bits, so the round trip is bit-exact.
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
    """(4, 4) pose, (B, G*R) uint32 table, scalar accumulators -> state.

    ``bucket_slots`` (G, ``Config.max_probes``) splits the table rows into
    slots; ``device`` ``None`` means CUDA (raises if absent); ``dtype`` is
    the pose's and the accumulators' (the state's float type).
    """
    dev = resolve_device(device)
    table = np.ascontiguousarray(table)
    if table.dtype != np.uint32 or table.ndim != 2:
        raise ValueError(f"table must be a 2-D uint32 array, got "
                         f"{table.dtype} {table.shape}")
    if table.shape[1] % bucket_slots:
        raise ValueError(f"table rows of {table.shape[1]} lanes do not split "
                         f"into {bucket_slots} slots")

    def scalar(x):
        return torch.tensor(float(np.asarray(x)), dtype=dtype, device=dev)

    return OdometryState(
        pose=torch.tensor(np.asarray(pose), dtype=dtype, device=dev),
        map=MapState(table=torch.from_numpy(table.view(np.int32).copy()
                                            ).to(dev),
                     bucket_slots=bucket_slots),
        threshold=ThresholdState(odom_sse=scalar(odom_sse),
                                 num_samples=scalar(num_samples)),
    )


def state_to_numpy(state: OdometryState):
    """State -> (pose (4, 4) f32, table (B, G*R) uint32, odom_sse,
    num_samples) numpy arrays."""
    return (state.pose.detach().cpu().numpy(),
            state.map.table.detach().cpu().numpy().view(np.uint32),
            state.threshold.odom_sse.detach().cpu().numpy(),
            state.threshold.num_samples.detach().cpu().numpy())
