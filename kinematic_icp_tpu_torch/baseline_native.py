"""Driver for the native CPU baseline (``native/kicp_baseline.cpp``).

Serializes a sequence to the binary harness protocol, runs the compiled
baseline, and returns (poses, stats).  The baseline is a C++17
implementation of the reference algorithm (reference pipeline
KinematicICP.cpp:48-85) in float64 with insertion-order downsampling: a
second differential oracle, which shares no code with this package.  It is
not part of the device compute path.

The binary is built from the source by ``utils.io.native.build`` into this
package's ``_build/`` with ``native/Makefile``'s flags (``-march=native``,
so it is built on the host that runs it); a prebuilt binary under
``native/`` is never run or written.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import tempfile

import numpy as np

from .config import Config
from .utils.io import native

_MAGIC = 0x4B49435042415345


def available() -> bool:
    """True if the baseline binary exists or can be built here."""
    try:
        native.built("kicp_baseline")
    except RuntimeError:
        return False
    return True


def serialize_sequence(cfg: Config, frames, rel_odometry, extrinsic,
                       *, num_threads: int = 0,
                       apply_stationary_gate: bool = True) -> bytes:
    """Pack (config, frames, odometry) into the harness wire format.

    ``frames`` is a list of ``(points (N,3), timestamps (N,) or None)``.
    ``num_threads=0`` means all hardware threads (the reference offline node's
    ``max_num_threads: 0`` convention, offline_node.launch.py:60).
    """
    out = [struct.pack("<q", _MAGIC)]
    out.append(np.asarray([
        cfg.max_range, cfg.min_range, cfg.voxel_size, cfg.fixed_threshold,
        cfg.convergence_criterion, cfg.fixed_regularization,
    ], np.float64).tobytes())
    out.append(np.asarray([
        cfg.max_points_per_voxel, cfg.max_num_iterations,
        int(cfg.use_adaptive_threshold),
        int(cfg.use_adaptive_odometry_regularization),
        int(cfg.deskew), num_threads,
    ], np.int64).tobytes())
    out.append(struct.pack("<q", int(apply_stationary_gate)))
    out.append(np.asarray(extrinsic, np.float64).reshape(16).tobytes())
    out.append(struct.pack("<q", len(frames)))
    for (pts, ts), rel in zip(frames, rel_odometry):
        pts = np.ascontiguousarray(pts, np.float64)
        out.append(struct.pack("<q", pts.shape[0]))
        out.append(pts.tobytes())
        has_ts = ts is not None and len(ts) == pts.shape[0]
        out.append(struct.pack("<q", int(has_ts)))
        if has_ts:
            out.append(np.ascontiguousarray(ts, np.float64).tobytes())
        out.append(np.asarray(rel, np.float64).reshape(16).tobytes())
    return b"".join(out)


def run_baseline(cfg: Config, frames, rel_odometry, extrinsic,
                 *, num_threads: int = 0, apply_stationary_gate: bool = True,
                 timeout: float = 600.0):
    """Run the native baseline over a sequence.

    Returns ``(poses (F,4,4) float64, stats dict)`` where ``stats`` has
    ``fps``, ``elapsed_s``, ``frames``, ``threads``.  Raises RuntimeError if
    the binary cannot be built or fails.
    """
    binary = native.built("kicp_baseline")
    payload = serialize_sequence(
        cfg, frames, rel_odometry, extrinsic, num_threads=num_threads,
        apply_stationary_gate=apply_stationary_gate)
    with tempfile.TemporaryDirectory(prefix="kicp_baseline_") as td:
        in_path = os.path.join(td, "in.bin")
        out_path = os.path.join(td, "poses.bin")
        with open(in_path, "wb") as f:
            f.write(payload)
        proc = subprocess.run([str(binary), in_path, out_path],
                              capture_output=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kicp_baseline failed rc={proc.returncode}: "
                f"{proc.stderr.decode(errors='replace')[:500]}")
        stats = json.loads(proc.stdout.decode().strip().splitlines()[-1])
        poses = np.fromfile(out_path, np.float64).reshape(-1, 4, 4)
    if poses.shape[0] != len(frames):
        raise RuntimeError(f"kicp_baseline returned {poses.shape[0]} poses "
                           f"for {len(frames)} frames")
    return poses, stats
