"""The benchmark's synthetic world, sensor and trajectory.

A frozen copy of ``kinematic_icp_tpu_torch/utils/synthetic.py`` at commit
dc36a2491db637ba74eeae484c593953a0d99c15 (``SyntheticWorld``,
``LidarModel``, ``render_scan``, ``TrajectoryModel``, ``OdometryNoise``,
``_drop_segments_near_path``), owned by the benchmark so that a change to
the program cannot change its inputs.  Two departures from the original:
the robot's speed is a parameter of the traffic, and ``render_scans``
renders all the scans of a drive in a few large torch calls on the card,
their noise drawn from one ``torch.Generator`` a drive.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def planar_pose(x, y, yaw):
    T = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


@dataclasses.dataclass
class SyntheticWorld:
    """Rectangular arena with random interior box obstacles."""

    half_extent: float = 25.0
    num_boxes: int = 12
    wall_height: float = 3.0
    seed: object = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        e = self.half_extent
        segs = [(-e, -e, e, -e), (e, -e, e, e), (e, e, -e, e), (-e, e, -e, -e)]
        for _ in range(self.num_boxes):
            cx, cy = rng.uniform(-e * 0.7, e * 0.7, size=2)
            w, h = rng.uniform(0.8, 4.0, size=2)
            if math.hypot(cx, cy) < 4.0:
                continue  # keep the spawn area clear
            x0, y0, x1, y1 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
            segs += [(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)]
        self.segments = np.asarray(segs, np.float64)


@dataclasses.dataclass
class LidarModel:
    num_beams: int = 2048
    num_rings: int = 32
    ring_angles_deg: tuple = ()
    max_range: float = 80.0
    noise_sigma: float = 0.01
    scan_duration: float = 0.1
    sensor_height: float = 0.8
    ground: bool = True
    ground_roughness: float = 0.02

    def __post_init__(self):
        if len(self.ring_angles_deg) != self.num_rings:
            raise ValueError(f"{self.num_rings} rings need as many angles, "
                             f"got {len(self.ring_angles_deg)}")


def lidar_from_spec(spec: dict) -> LidarModel:
    """A ``LidarModel`` from a configuration's ``sensor`` entry: the rings
    spread evenly over ``[elevation_min_deg, elevation_max_deg]``."""
    rings = int(spec["rings"])
    angles = tuple(np.linspace(float(spec["elevation_min_deg"]),
                               float(spec["elevation_max_deg"]), rings))
    return LidarModel(num_beams=int(spec["columns"]), num_rings=rings,
                      ring_angles_deg=angles,
                      max_range=float(spec["max_range_m"]),
                      noise_sigma=float(spec["noise_sigma_m"]),
                      scan_duration=float(spec["scan_duration_s"]),
                      sensor_height=float(spec["height_m"]),
                      ground=bool(spec["ground"]),
                      ground_roughness=float(spec["ground_roughness_m"]))


def render_scans(segments, wall_height: float, lidar: LidarModel,
                 starts, ends, generator, device, chunk: int = 64):
    """The motion-skewed scans of a drive, all frames in a few large calls
    on ``device`` (torch, float64; the noise from ``generator``).

    ``starts``/``ends``: (F, 3) planar poses (x, y, yaw) at the start and
    end of each sweep.  Each column of beams is cast from the pose
    interpolated at its firing time; a ring's beam returns the wall it
    hits while the hit lies on the wall's face, else the ground (with the
    ground on) where the beam reaches it first.  Returns a list of F
    (points (N, 3) float32 in the end sensor frame, timestamps (N,)
    float32 in [0, 1)) numpy pairs.
    """
    import torch

    f64 = dict(dtype=torch.float64, device=device)
    A, V = lidar.num_beams, lidar.num_rings
    taus = torch.arange(A, **f64) / A
    beam = taus * 2.0 * math.pi
    tan_r = torch.tan(torch.deg2rad(torch.tensor(lidar.ring_angles_deg,
                                                 **f64)))
    seg = torch.as_tensor(np.asarray(segments, np.float64), **f64)
    x0s, y0s, x1s, y1s = seg.T
    ex, ey = x1s - x0s, y1s - y0s
    h = lidar.sensor_height
    d_ground = torch.where(tan_r < 0, h / torch.clamp(-tan_r, min=1e-12),
                           torch.full_like(tan_r, math.inf))
    starts = torch.as_tensor(np.asarray(starts, np.float64), **f64)
    ends = torch.as_tensor(np.asarray(ends, np.float64), **f64)
    flat, counts = [], []
    for a in range(0, len(starts), chunk):
        s0, s1 = starts[a:a + chunk], ends[a:a + chunk]
        dyaw = torch.remainder(s1[:, 2] - s0[:, 2] + math.pi,
                               2 * math.pi) - math.pi
        xs = s0[:, :1] + (s1[:, :1] - s0[:, :1]) * taus
        ys = s0[:, 1:2] + (s1[:, 1:2] - s0[:, 1:2]) * taus
        ang = s0[:, 2:3] + dyaw[:, None] * taus + beam
        dx, dy = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        denom = dx * (-ey) + dy * ex
        rx, ry = x0s - xs[..., None], y0s - ys[..., None]
        ok = torch.abs(denom) >= 1e-12
        denom = torch.where(ok, denom, 1.0)
        t = (rx * (-ey) + ry * ex) / denom
        u = (dx * ry - dy * rx) / denom
        t = torch.where(ok & (t > 1e-6) & (u >= 0.0) & (u <= 1.0), t,
                        math.inf)
        d = t.amin(-1)                                          # (F, A)
        hit = torch.isfinite(d) & (d < lidar.max_range)
        z = d[..., None] * tan_r                                # (F, A, V)
        shape = z.shape
        if lidar.ground:
            wall_valid = hit[..., None] & (z > -h) & (z < wall_height - h)
            d_wall = torch.where(hit, d, math.inf)[..., None]
            ground_valid = (d_ground < d_wall) & (d_ground < lidar.max_range)
            planar = torch.where(ground_valid, d_ground, d[..., None])
            rough = torch.randn(shape, generator=generator, **f64)
            z = torch.where(ground_valid,
                            -h + lidar.ground_roughness * rough, z)
            valid = ground_valid | wall_valid
        else:
            planar = d[..., None].expand(shape)
            valid = hit[..., None] & (z > -0.5) & (z < wall_height)
        dd = planar + lidar.noise_sigma * torch.randn(
            shape, generator=generator, **f64)
        pts = torch.stack([dd * torch.cos(beam)[:, None],
                           dd * torch.sin(beam)[:, None], z], -1)
        ts = taus[:, None].expand(A, V).expand(shape)
        flat.append(torch.cat([pts[valid], ts[valid][:, None]], -1)
                    .to(torch.float32).cpu())
        counts.append(valid.sum((1, 2)).cpu())
    rows = torch.cat(flat).numpy()
    bounds = np.cumsum(torch.cat(counts).numpy())[:-1]
    return [(np.ascontiguousarray(p[:, :3]), np.ascontiguousarray(p[:, 3]))
            for p in np.split(rows, bounds)]


@dataclasses.dataclass
class TrajectoryModel:
    """Smooth wandering unicycle trajectory inside the arena."""

    speed: float = 0.2          # m/frame
    yaw_rate: float = 0.03      # rad/frame baseline
    seed: object = 1

    def poses(self, num_frames, world: SyntheticWorld):
        rng = np.random.default_rng(self.seed)
        x, y, yaw = 0.0, 0.0, 0.0
        out = [planar_pose(x, y, yaw)]
        w = self.yaw_rate
        for _ in range(num_frames - 1):
            w = 0.95 * w + rng.normal(0, 0.01)
            margin = world.half_extent * 0.75
            if abs(x) > margin or abs(y) > margin:
                target = math.atan2(-y, -x)
                err = (target - yaw + np.pi) % (2 * np.pi) - np.pi
                w = np.clip(err * 0.2, -0.12, 0.12)
            yaw += w
            x += self.speed * math.cos(yaw)
            y += self.speed * math.sin(yaw)
            out.append(planar_pose(x, y, yaw))
        return out


@dataclasses.dataclass
class OdometryNoise:
    """Multiplicative random-walk noise on the per-frame odometry delta."""

    sigma_xy: float = 0.01
    sigma_yaw: float = 0.004
    seed: object = 2

    def corrupt(self, deltas):
        rng = np.random.default_rng(self.seed)
        out = []
        for d in deltas:
            n = planar_pose(rng.normal(0, self.sigma_xy),
                            rng.normal(0, self.sigma_xy),
                            rng.normal(0, self.sigma_yaw))
            out.append(d @ n)
        return out


def drop_segments_near_path(segments, path_xy, margin):
    """Remove interior segments closer than ``margin`` to the path (the
    first four, the arena's walls, stay), so no drive passes through a
    box."""
    walls, rest = segments[:4], segments[4:]
    if len(rest) == 0:
        return segments
    p0 = rest[:, None, 0:2]
    d = rest[:, None, 2:4] - p0
    rel = path_xy[None, :, :] - p0
    len2 = np.maximum(np.sum(d * d, axis=-1), 1e-12)
    t = np.clip(np.sum(rel * d, axis=-1) / len2, 0.0, 1.0)
    closest = p0 + t[..., None] * d
    dist = np.linalg.norm(path_xy[None, :, :] - closest, axis=-1)
    keep = np.min(dist, axis=1) > margin
    return np.concatenate([walls, rest[keep]], axis=0)
