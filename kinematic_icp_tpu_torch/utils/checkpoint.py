"""Odometry state snapshot / restore.

The reference has no checkpointing (its closest analogue is the destructive
``set_pose`` reset).  The complete device state (pose, packed voxel map,
threshold accumulators) round-trips through one compressed npz, making long
sequences resumable and serving deployments restartable.

The file format is the JAX package's (format version 3, the same keys, the
table as uint32, the same meta JSON with the config under JAX's backend
names), so a checkpoint written by either package loads into the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import Config
from ..convert import state_from_numpy, state_to_numpy
from ..models.pipeline import OdometryState

_FORMAT_VERSION = 3  # v3: bucket_of hash changed (additive+murmur); v2 tables
# have every voxel in a different bucket and must not load silently

#: numpy dtypes of the pose a checkpoint may hold -> the state's torch dtype
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def save_state(path, state: OdometryState, config: Config | None = None,
               extra: dict | None = None):
    """Write the full odometry state (and optionally its config) to npz."""
    meta = {"format_version": _FORMAT_VERSION,
            "bucket_slots": state.map.bucket_slots}
    if config is not None:
        meta["config"] = config.to_jax_dict()
    if extra:
        meta["extra"] = extra
    pose, table, sse, n = state_to_numpy(state)
    np.savez_compressed(
        path, pose=pose, map_table=table, threshold_sse=sse, threshold_n=n,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


def load_state(path, device=None):
    """Returns (OdometryState on ``device``, meta dict).  ``device``
    ``None`` means CUDA (raises if absent); the state keeps the saved
    pose's float type."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('format_version')}")
        pose = z["pose"]
        if pose.dtype not in _DTYPES:
            raise ValueError(f"checkpoint pose has dtype {pose.dtype}")
        state = state_from_numpy(
            pose, z["map_table"], z["threshold_sse"], z["threshold_n"],
            bucket_slots=int(meta["bucket_slots"]), device=device,
            dtype=_DTYPES[pose.dtype])
    return state, meta


def load_config(meta: dict) -> Config | None:
    if "config" not in meta:
        return None
    return Config.from_dict(meta["config"])
