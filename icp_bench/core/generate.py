"""Seeded drives: trajectory, noisy wheel odometry and rendered scans.

One general generator for every traffic mix: a mix names how many drives
it needs and how long each is, the configuration names the sensor and the
world, and the seed of the run fixes everything else.  Drive ``d`` of seed
``s`` draws its world (the arena's boxes) from ``[s, d, 0]``, its
trajectory from ``[s, d, 1]``, its odometry noise from ``[s, d, 2]`` and
its scans' noise from a ``torch.Generator`` seeded from ``[s, d, 3]``.
Where the mix names a ``catalogue`` of drive ids, drive ``d`` is instead
catalogue drive ``c``: its world, trajectory and odometry noise drawn
from ``[0, c, 0]``, ``[0, c, 1]`` and ``[0, c, 2]`` whatever the seed,
the catalogue's order from the seed, and its scans' noise from
``[s, c, 3]``.  Every seed then drives the same places along the same
paths from the same odometry, in another order and with other scans: the
program sees other inputs on each seed, and is asked for nearly the same
work (the odometry noise, drawn from the seed too, moved the work of the
certified solve's fallback by up to 15 %).  The scans of a drive are
rendered on ``device`` in a few large calls and come back to the host as
numpy arrays.
"""

from __future__ import annotations

import numpy as np

from . import world as w


def plan(seed: int, drive: int, frames: int, world_spec: dict,
         speed: float, fixed_seed: int | None = None) -> dict:
    """A drive without its scans: the world's segments, ground-truth
    poses, the noisy odometry deltas (the first is the identity) and the
    extrinsic (the identity: the sensor is the base's origin, raised by
    the sensor's height inside the renderer).  The world, trajectory and
    odometry noise are drawn from ``fixed_seed`` where it is given, else
    from ``seed``."""
    place = seed if fixed_seed is None else fixed_seed
    arena = w.SyntheticWorld(half_extent=float(world_spec["half_extent_m"]),
                             num_boxes=int(world_spec["boxes"]),
                             wall_height=float(world_spec["wall_height_m"]),
                             seed=[place, drive, 0])
    traj = w.TrajectoryModel(speed=speed,
                             yaw_rate=float(world_spec["yaw_rate_rad"]),
                             seed=[place, drive, 1])
    gt = traj.poses(frames, arena)
    path = np.asarray([[g[0, 3], g[1, 3]] for g in gt])
    arena.segments = w.drop_segments_near_path(
        arena.segments, path, float(world_spec["clear_path_margin_m"]))
    noise = w.OdometryNoise(sigma_xy=float(world_spec["odom_sigma_xy_m"]),
                            sigma_yaw=float(world_spec["odom_sigma_yaw_rad"]),
                            seed=[place, drive, 2])
    true = [np.eye(4)] + [np.linalg.inv(gt[k - 1]) @ gt[k]
                          for k in range(1, frames)]
    return {"segments": arena.segments, "wall_height": arena.wall_height,
            "gt_poses": gt, "rel_odometry": [true[0]] + noise.corrupt(true[1:]),
            "extrinsic": np.eye(4)}


def _planar(T):
    return (T[0, 3], T[1, 3], np.arctan2(T[1, 0], T[0, 0]))


def drives(seed: int, count: int, frames: int, sensor: dict,
           world_spec: dict, speed: float, device="cpu",
           catalogue=None):
    """``count`` drives of ``frames`` scans each: a list of dicts with
    ``frames`` (list of (points (N, 3) float32, timestamps (N,) float32)),
    ``rel_odometry``, ``gt_poses`` and ``extrinsic``."""
    import torch

    if catalogue is not None:
        if len(catalogue) < count:
            raise ValueError(f"a catalogue of {len(catalogue)} drives for "
                             f"{count}")
        order = np.random.default_rng([seed, 4]).permutation(len(catalogue))
        sources = [(0, int(catalogue[i])) for i in order[:count]]
    else:
        sources = [(None, d) for d in range(count)]
    lidar = w.lidar_from_spec(sensor)
    out = []
    for place, d in sources:
        p = plan(seed, d, frames, world_spec, speed, place)
        gt = p["gt_poses"]
        ends = np.asarray([_planar(g @ p["extrinsic"]) for g in gt])
        starts = np.concatenate([ends[:1], ends[:-1]])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.default_rng([seed, d, 3]).integers(
            2**62)))
        p["frames"] = w.render_scans(p.pop("segments"), p.pop("wall_height"),
                                     lidar, starts, ends, gen, device)
        out.append(p)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out
