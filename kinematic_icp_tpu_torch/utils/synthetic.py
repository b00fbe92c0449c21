"""Synthetic LiDAR world: scan rendering + noisy wheel odometry (numpy).

A self-contained, deterministic data source for tests and the chip smoke
run: a planar robot driving through a walled world, multi-ring scans
rendered by 2D ray casting against wall segments, intra-scan motion skew,
and wheel odometry corrupted by a seeded noise random walk.  The same seeds
give the same arrays as the JAX package's generator.
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
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        e = self.half_extent
        # segments as (x0, y0, x1, y1)
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

    def raycast(self, origins, angles):
        """Batch 2D ray casting with per-ray origins.

        Args:
          origins: (A, 2) ray origins.
          angles: (A,) world-frame ray directions.

        Returns (A,) distance to the nearest segment (inf on miss).
        """
        origins = np.atleast_2d(origins)
        ox, oy = origins[:, 0][:, None], origins[:, 1][:, None]   # (A, 1)
        dx = np.cos(angles)[:, None]
        dy = np.sin(angles)[:, None]
        x0, y0, x1, y1 = self.segments.T                           # (S,)
        ex, ey = (x1 - x0)[None, :], (y1 - y0)[None, :]
        # Solve o + t d = p0 + u e for t > 0, u in [0, 1].
        denom = dx * (-ey) + dy * ex
        denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
        rx, ry = x0[None, :] - ox, y0[None, :] - oy
        t = (rx * (-ey) + ry * ex) / denom
        u = (dx * ry - dy * rx) / denom
        t = np.where((t > 1e-6) & (u >= 0.0) & (u <= 1.0), t, np.inf)
        return np.min(np.where(np.isnan(t), np.inf, t), axis=1)


@dataclasses.dataclass
class LidarModel:
    num_beams: int = 720
    num_rings: int = 8
    ring_angles_deg: tuple = (-15, -10, -6, -3, 0, 3, 8, 15)
    max_range: float = 80.0
    noise_sigma: float = 0.01
    scan_duration: float = 0.1  # seconds
    #: sensor height above ground (used only when ``ground`` is on)
    sensor_height: float = 0.8
    #: render a ground plane: downward beams that reach the floor before a
    #: wall return a ground hit.  Real 3D lidar frames are dominated by
    #: ground returns; without this the synthetic world downsamples to
    #: unrealistically few keypoints (walls only).  Off by default to keep
    #: the small test workload.
    ground: bool = False
    #: ground roughness sigma (m); gives the ground annulus realistic
    #: sub-voxel structure instead of a perfect plane
    ground_roughness: float = 0.02

    def __post_init__(self):
        assert len(self.ring_angles_deg) == self.num_rings, (
            f"{self.num_rings} rings need {self.num_rings} ring_angles_deg "
            f"(got {len(self.ring_angles_deg)})")


def render_scan(world: SyntheticWorld, lidar: LidarModel, pose_start,
                pose_end, rng):
    """Render one (skewed) scan in the sensor frame.

    Beams fire sequentially over ``scan_duration`` while the sensor moves
    from ``pose_start`` to ``pose_end``; each column of beams is cast from
    the interpolated pose, producing a motion-skewed scan exactly like a
    spinning lidar.  Returns (points (N, 3) float32 in the *end* sensor
    frame distorted by motion — i.e. raw uncompensated data, timestamps
    (N,) in [0, 1], and the per-point world hits for debugging).
    """
    A, V = lidar.num_beams, lidar.num_rings
    taus = np.linspace(0.0, 1.0, A, endpoint=False)
    beam_angles = taus * 2.0 * np.pi  # sensor-frame azimuth over one rev
    ring = np.deg2rad(np.asarray(lidar.ring_angles_deg, np.float64))

    # Interpolate the sensor pose per azimuth column.
    x0, y0 = pose_start[0, 3], pose_start[1, 3]
    yaw0 = math.atan2(pose_start[1, 0], pose_start[0, 0])
    x1, y1 = pose_end[0, 3], pose_end[1, 3]
    yaw1 = math.atan2(pose_end[1, 0], pose_end[0, 0])
    dyaw = (yaw1 - yaw0 + np.pi) % (2 * np.pi) - np.pi

    xs = x0 + (x1 - x0) * taus
    ys = y0 + (y1 - y0) * taus
    yaws = yaw0 + dyaw * taus

    world_angles = yaws + beam_angles
    origins = np.stack([xs, ys], axis=1)
    d = world.raycast(origins, world_angles)                     # (A,)
    hit = np.isfinite(d) & (d < lidar.max_range)

    # A beam that hits a wall at planar distance d produces, per ring, a
    # sensor-frame point (d cos az, d sin az, d tan elev) — valid only while
    # the elevated hit stays on the wall face (0..wall_height above ground).
    tan_r = np.tan(ring)                                         # (V,)
    z = d[:, None] * tan_r[None, :]                              # (A, V)
    if lidar.ground:
        h = lidar.sensor_height
        wall_valid = hit[:, None] & (z > -h) & (z < world.wall_height - h)
        # Downward beams reach the floor at planar distance h/tan(-elev);
        # the ground hit wins if it is closer than the blocking wall.
        with np.errstate(divide="ignore"):
            d_ground = np.where(tan_r < 0, h / np.maximum(-tan_r, 1e-12),
                                np.inf)[None, :]                 # (1, V)
        d_wall = np.where(hit, d, np.inf)[:, None]               # (A, 1)
        ground_valid = ((d_ground < d_wall)
                        & (d_ground < lidar.max_range))          # (A, V)
        planar = np.where(ground_valid, d_ground, d[:, None])
        z = np.where(ground_valid,
                     -h + rng.normal(0.0, lidar.ground_roughness,
                                     size=z.shape), z)
        valid = ground_valid | wall_valid
    else:
        planar = d[:, None]
        valid = hit[:, None] & (z > -0.5) & (z < world.wall_height)
    dd = planar + rng.normal(0.0, lidar.noise_sigma, size=(A, V))
    lx = dd * np.cos(beam_angles)[:, None]
    ly = dd * np.sin(beam_angles)[:, None]
    pts = np.stack([lx, ly, z], axis=-1)[valid]                  # (N, 3)
    ts = np.broadcast_to(taus[:, None], (A, V))[valid]
    return pts.astype(np.float32), ts.astype(np.float32)


@dataclasses.dataclass
class TrajectoryModel:
    """Smooth wandering unicycle trajectory inside the arena."""

    speed: float = 0.5          # m/frame
    yaw_rate: float = 0.03      # rad/frame baseline
    seed: int = 1

    def poses(self, num_frames, world: SyntheticWorld):
        rng = np.random.default_rng(self.seed)
        x, y, yaw = 0.0, 0.0, 0.0
        out = [planar_pose(x, y, yaw)]
        w = self.yaw_rate
        for _ in range(num_frames - 1):
            w = 0.95 * w + rng.normal(0, 0.01)
            # steer away from walls
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
    seed: int = 2

    def corrupt(self, deltas):
        rng = np.random.default_rng(self.seed)
        out = []
        for d in deltas:
            n = planar_pose(rng.normal(0, self.sigma_xy),
                            rng.normal(0, self.sigma_xy),
                            rng.normal(0, self.sigma_yaw))
            out.append(d @ n)
        return out


def realistic_lidar(num_beams: int = 2048, num_rings: int = 32) -> LidarModel:
    """A Velodyne-class 3D lidar model: ~64K rays/rev, ground returns on.

    With the default rings, most downward beams hit the ground annulus
    (1.7 m .. ~45 m), which dominates the return count exactly like real
    outdoor scans — this is the model behind the large bench regime.
    """
    return LidarModel(
        num_beams=num_beams, num_rings=num_rings,
        ring_angles_deg=tuple(np.linspace(-25.0, 10.0, num_rings)),
        ground=True)


def _drop_segments_near_path(segments, path_xy, margin):
    """Remove non-wall segments closer than ``margin`` to any path point.

    The first 4 segments (the arena walls) are always kept.  Guards the
    bench trajectory from driving *through* an interior box, which renders
    degenerate all-close-range frames.
    """
    walls, rest = segments[:4], segments[4:]
    if len(rest) == 0:
        return segments
    p0 = rest[:, None, 0:2]                          # (S, 1, 2)
    d = rest[:, None, 2:4] - p0                      # (S, 1, 2)
    rel = path_xy[None, :, :] - p0                   # (S, P, 2)
    len2 = np.maximum(np.sum(d * d, axis=-1), 1e-12)
    t = np.clip(np.sum(rel * d, axis=-1) / len2, 0.0, 1.0)
    closest = p0 + t[..., None] * d
    dist = np.linalg.norm(path_xy[None, :, :] - closest, axis=-1)
    keep = np.min(dist, axis=1) > margin             # (S,)
    return np.concatenate([walls, rest[keep]], axis=0)


def make_sequence(num_frames=50, *, world_seed=0, traj_seed=1, noise_seed=2,
                  lidar: LidarModel | None = None,
                  noise: OdometryNoise | None = None,
                  extrinsic: np.ndarray | None = None,
                  clear_path_margin: float | None = None):
    """Generate a full synthetic sequence.

    Returns a dict with:
      frames: list of (points (N_i, 3) f32 lidar frame, timestamps (N_i,) f32)
      rel_odometry: list of (4, 4) noisy wheel-odometry deltas (base frame)
      gt_poses: list of (4, 4) ground-truth base poses
      extrinsic: (4, 4) lidar-to-base
    """
    world = SyntheticWorld(seed=world_seed)
    lidar = lidar or LidarModel()
    noise = noise or OdometryNoise(seed=noise_seed)
    traj = TrajectoryModel(seed=traj_seed)
    gt = traj.poses(num_frames, world)
    if clear_path_margin is not None:
        path_xy = np.asarray([[g[0, 3], g[1, 3]] for g in gt])
        world.segments = _drop_segments_near_path(
            world.segments, path_xy, clear_path_margin)
    ext = np.eye(4) if extrinsic is None else np.asarray(extrinsic, np.float64)

    rng = np.random.default_rng(world_seed + 1000)
    frames = []
    sensor_poses = [g @ ext for g in gt]
    for k in range(num_frames):
        start = sensor_poses[k - 1] if k > 0 else sensor_poses[0]
        frames.append(render_scan(world, lidar, start, sensor_poses[k], rng))

    true_deltas = [np.eye(4)] + [
        np.linalg.inv(gt[k - 1]) @ gt[k] for k in range(1, num_frames)]
    rel = [true_deltas[0]] + noise.corrupt(true_deltas[1:])
    return {
        "frames": frames,
        "rel_odometry": rel,
        "gt_poses": gt,
        "extrinsic": ext,
        "world": world,
        "scan_duration": lidar.scan_duration,
    }


def sequence_messages(seq, *, base_frame="base_link", odom_frame="odom",
                      lidar_frame="lidar", rate_hz=10.0,
                      start_time=1700000000.0):
    """A synthetic sequence as the in-memory message stream of a live robot:
    ``(kind, message)`` tuples for ``online.OnlineOdometryNode.run``.

    The same surface as the JAX package's ``write_sequence_to_mcap``, in
    memory: the static extrinsic on ``tf_static`` (base -> lidar), then per
    frame the noisy integrated wheel odometry on ``tf`` (odom -> base at
    the scan's end stamp) and the scan as a PointCloud2 stamped at the scan
    start, with a float32 ``t`` field of scan-relative seconds (the
    convention the reference's stamp heuristic classifies robustly).
    """
    from .io.messages import (PointCloud2, PointFieldType, TFMessage,
                              TransformStamped)

    dt = 1.0 / rate_hz
    scan_dur = seq.get("scan_duration", 0.1)
    out = [("tf_static", TFMessage([TransformStamped.from_matrix(
        seq["extrinsic"], start_time, base_frame, lidar_frame)]))]
    odom_pose = np.eye(4)
    for k, (pts, taus) in enumerate(seq["frames"]):
        stamp = start_time + k * dt  # end-of-scan stamp
        odom_pose = odom_pose @ seq["rel_odometry"][k]
        out.append(("tf", TFMessage([TransformStamped.from_matrix(
            odom_pose, stamp, odom_frame, base_frame)])))
        out.append(("pointcloud", PointCloud2.from_xyz(
            pts, stamp=stamp - scan_dur, frame_id=lidar_frame,
            timestamps=np.asarray(taus, np.float32) * scan_dur,
            timestamp_field="t", timestamp_type=PointFieldType.FLOAT32)))
    return out


def render_2d_scan(world: SyntheticWorld, pose, *, num_beams=360,
                   scan_duration=0.1, range_max=40.0, noise_sigma=0.01,
                   rng=None):
    """Planar LaserScan ranges from a pose (for the 2D ingestion path)."""
    rng = rng or np.random.default_rng(0)
    x, y = pose[0, 3], pose[1, 3]
    yaw = math.atan2(pose[1, 0], pose[0, 0])
    angle_min, angle_max = -np.pi, np.pi
    inc = 2 * np.pi / num_beams
    beam_angles = angle_min + np.arange(num_beams) * inc
    origins = np.tile([[x, y]], (num_beams, 1))
    d = world.raycast(origins, yaw + beam_angles)
    d = d + rng.normal(0, noise_sigma, num_beams)
    d = np.where(np.isfinite(d) & (d < range_max), d, np.inf)
    return dict(angle_min=angle_min, angle_max=angle_max,
                angle_increment=inc,
                time_increment=scan_duration / num_beams,
                scan_time=scan_duration, range_min=0.05, range_max=range_max,
                ranges=d.astype(np.float32))


def write_sequence_to_mcap(seq, path, *, lidar_topic="/lidar_points",
                           base_frame="base_link", odom_frame="odom",
                           lidar_frame="lidar", rate_hz=10.0,
                           start_time=1700000000.0,
                           scan_2d_topic=None):
    """Serialize a synthetic sequence as a ROS2-style mcap bag.

    Publishes the scans on ``lidar_topic`` (PointCloud2, begin-of-scan
    header stamping with a float32 ``t`` field of scan-relative seconds —
    the convention the reference's stamp heuristic classifies robustly;
    end-of-scan absolute stamping cannot satisfy its 1e-8 equality check in
    float64 at epoch magnitudes), the NOISY integrated wheel odometry on
    ``/tf`` (odom -> base_link), and the static extrinsic on ``/tf_static``
    — the exact input surface the reference offline node consumes.  With
    ``scan_2d_topic``, each frame also carries a LaserScan of the same
    world on that topic.  The same arguments give the same bytes as the JAX
    package's writer.
    """
    from .io.mcap import McapWriter
    from .io.messages import (Header, LaserScan, PointCloud2, PointFieldType,
                              TFMessage, Time, TransformStamped)

    dt = 1.0 / rate_hz
    scan_dur = seq.get("scan_duration", 0.1)
    rng2d = np.random.default_rng(99)
    writer = McapWriter(path)
    # static extrinsic
    static = TFMessage([TransformStamped.from_matrix(
        seq["extrinsic"], start_time, base_frame, lidar_frame)])
    writer.write_message("/tf_static", "tf2_msgs/msg/TFMessage",
                         static.encode(), int(start_time * 1e9))
    odom_pose = np.eye(4)
    num_frames = len(seq["frames"])
    for k in range(num_frames):
        stamp = start_time + k * dt  # end-of-scan stamp
        odom_pose = odom_pose @ seq["rel_odometry"][k]
        tf_msg = TFMessage([TransformStamped.from_matrix(
            odom_pose, stamp, odom_frame, base_frame)])
        writer.write_message("/tf", "tf2_msgs/msg/TFMessage",
                             tf_msg.encode(), int(stamp * 1e9))
        pts, taus = seq["frames"][k]
        # begin-stamped: header at scan start, per-point times relative; the
        # TimeStampHandler extends the end stamp by the scan duration.
        rel_ts = np.asarray(taus, np.float32) * scan_dur
        cloud = PointCloud2.from_xyz(
            pts, stamp=stamp - scan_dur, frame_id=lidar_frame,
            timestamps=rel_ts, timestamp_field="t",
            timestamp_type=PointFieldType.FLOAT32)
        writer.write_message(lidar_topic, "sensor_msgs/msg/PointCloud2",
                             cloud.encode(), int(stamp * 1e9))
        if scan_2d_topic:
            gt_sensor = seq["gt_poses"][k] @ seq["extrinsic"]
            kw = render_2d_scan(seq["world"], gt_sensor,
                                scan_duration=scan_dur, rng=rng2d)
            scan = LaserScan(header=Header(Time.from_sec(stamp - scan_dur),
                                           lidar_frame),
                             intensities=np.zeros(0, np.float32), **kw)
            writer.write_message(scan_2d_topic, "sensor_msgs/msg/LaserScan",
                                 scan.encode(), int(stamp * 1e9))
    writer.close()
    return path
