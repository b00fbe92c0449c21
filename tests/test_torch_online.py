"""Port vs JAX: message I/O (CDR, timestamps, tf, LaserScan, TUM), the
server's message interface and the online node."""

import dataclasses

import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu.online import OnlineOdometryNode as JNode
from kinematic_icp_tpu.server import LidarOdometryServer as JServer
from kinematic_icp_tpu.utils.io import laserscan as jlaser
from kinematic_icp_tpu.utils.io import messages as jmsg
from kinematic_icp_tpu.utils.io import native as jnative
from kinematic_icp_tpu.utils.io import tf as jtf
from kinematic_icp_tpu.utils.io import timestamps as jts
from kinematic_icp_tpu.utils.io import tum as jtum
from kinematic_icp_tpu_torch import Config, ServerConfig
from kinematic_icp_tpu_torch.online import OnlineOdometryNode
from kinematic_icp_tpu_torch.server import LidarOdometryServer
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse
from kinematic_icp_tpu_torch.utils.io import laserscan as tlaser
from kinematic_icp_tpu_torch.utils.io import messages as tmsg
from kinematic_icp_tpu_torch.utils.io import native as tnative
from kinematic_icp_tpu_torch.utils.io import tf as ttf
from kinematic_icp_tpu_torch.utils.io import timestamps as tts
from kinematic_icp_tpu_torch.utils.io import tum as ttum

torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_aux.py:87-88
CFG = dict(max_points=4096, max_downsampled=4096, max_source=1024,
           map_capacity=1 << 13, max_range=60.0, deskew=True)
FRAMES = 12


def _scan(m, seed=0, n=360):
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(0.2, 30.0, n).astype(np.float32)
    ranges[::17] = np.inf
    ranges[5::23] = np.nan
    return m.LaserScan(
        header=m.Header(m.Time(1700000000, 250000000), "laser"),
        angle_min=-np.pi, angle_max=np.pi, angle_increment=2 * np.pi / n,
        time_increment=1e-4, scan_time=0.1, range_min=0.5, range_max=25.0,
        ranges=ranges, intensities=rng.uniform(0, 1, n).astype(np.float32))


def _message(kind, m):
    rng = np.random.default_rng(7)
    pose = synthetic.planar_pose(3.0, -1.0, 0.4)
    pose[2, 3] = 0.25
    if kind == "PointCloud2":
        pts = rng.uniform(-30, 30, (257, 3)).astype(np.float32)
        return m.PointCloud2.from_xyz(
            pts, stamp=1700000000.05, frame_id="lidar",
            timestamps=rng.uniform(0, 0.1, 257).astype(np.float64),
            timestamp_field="timestamp",
            timestamp_type=m.PointFieldType.FLOAT64)
    if kind == "LaserScan":
        return _scan(m)
    if kind == "TFMessage":
        return m.TFMessage([
            m.TransformStamped.from_matrix(pose, 1700000000.1, "odom",
                                           "base_link"),
            m.TransformStamped.from_matrix(np.linalg.inv(pose), 12.5,
                                           "base_link", "lidar")])
    cov = rng.uniform(0, 1, 36)
    return m.Odometry(
        header=m.Header(m.Time.from_sec(1700000000.2), "odom_lidar"),
        child_frame_id="base_link", position=pose[:3, 3].copy(),
        orientation=np.array([0.0, 0.0, np.sin(0.2), np.cos(0.2)]),
        pose_covariance=cov, twist_linear=rng.normal(size=3),
        twist_angular=rng.normal(size=3), twist_covariance=cov[::-1].copy())


@pytest.mark.parametrize("kind", ["PointCloud2", "LaserScan", "TFMessage",
                                  "Odometry"])
def test_cdr_bytes_cross_packages(kind):
    """JAX encode -> port decode -> port encode gives JAX's bytes; the
    port's own message encodes to the same bytes; and JAX decodes it."""
    jbytes = _message(kind, jmsg).encode()
    tcls, jcls = getattr(tmsg, kind), getattr(jmsg, kind)
    assert tcls.decode(jbytes).encode() == jbytes
    tbytes = _message(kind, tmsg).encode()
    assert tbytes == jbytes
    assert jcls.decode(tbytes).encode() == jbytes
    assert tmsg.SCHEMA_DECODERS.keys() == jmsg.SCHEMA_DECODERS.keys()


def test_pointcloud_fields_match_jax(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)  # numpy path
    payload = _message("PointCloud2", jmsg).encode()
    jcloud, tcloud = jmsg.PointCloud2.decode(payload), \
        tmsg.PointCloud2.decode(payload)
    np.testing.assert_array_equal(tcloud.xyz(), jcloud.xyz())
    np.testing.assert_array_equal(tcloud.field_array("timestamp"),
                                  jcloud.field_array("timestamp"))
    assert tcloud.field("none") is None and tcloud.field_array("none") is None


def test_timestamp_handler_matches_jax():
    seq = synthetic.make_sequence(4)
    jh, th = jts.TimeStampHandler(), tts.TimeStampHandler()
    clouds = [m for k, m in synthetic.sequence_messages(seq)
              if k == "pointcloud"]
    # also an end-stamped cloud of FLOAT64 nanosecond stamps, and one
    # without stamps
    ns = np.linspace(1.7e18, 1.7e18 + 1e8, 50)
    clouds.append(tmsg.PointCloud2.from_xyz(
        np.ones((50, 3)), stamp=ns[-1] * 1e-9, timestamps=ns,
        timestamp_field="time", timestamp_type=tmsg.PointFieldType.FLOAT64))
    clouds.append(tmsg.PointCloud2.from_xyz(np.ones((5, 3)), stamp=3.0))
    for cloud in clouds:
        jc = jmsg.PointCloud2.decode(cloud.encode())
        jb, je, jn = jh.process_timestamps(jc)
        tb, te, tn = th.process_timestamps(cloud)
        assert (tb, te) == (jb, je)
        if jn is None:
            assert tn is None
        else:
            np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(
        tts.extract_timestamps(clouds[-2]),
        jts.extract_timestamps(jmsg.PointCloud2.decode(clouds[-2].encode())))


def test_transform_buffer_matches_jax():
    seq = synthetic.make_sequence(6)
    jb, tb = jtf.TransformBuffer(), ttf.TransformBuffer()
    for kind, msg in synthetic.sequence_messages(seq):
        if kind.startswith("tf"):
            jm = jmsg.TFMessage.decode(msg.encode())
            for jt, tt in zip(jm.transforms, msg.transforms):
                jb.add_transform_stamped(jt, is_static=kind == "tf_static")
                tb.add_transform_stamped(tt, is_static=kind == "tf_static")
    t0 = 1700000000.0
    for stamp in (None, t0 - 1.0, t0, t0 + 0.05, t0 + 0.33, t0 + 9.0):
        for target, source in (("odom", "base_link"), ("odom", "lidar"),
                               ("lidar", "odom"), ("base_link", "lidar"),
                               ("odom", "nowhere")):
            np.testing.assert_array_equal(
                tb.lookup_transform(target, source, stamp),
                jb.lookup_transform(target, source, stamp))
    np.testing.assert_array_equal(
        tb.lookup_delta_transform("base_link", t0 + 0.1, t0 + 0.25, "odom"),
        jb.lookup_delta_transform("base_link", t0 + 0.1, t0 + 0.25, "odom"))
    assert tb.frame_exists("lidar") and not tb.frame_exists("map")


def test_project_laser_matches_jax_numpy_path(monkeypatch):
    """Both packages' numpy paths (each also has a native one, held to
    JAX's in tests/test_torch_io.py)."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    jcloud = jlaser.project_laser(_scan(jmsg))
    tcloud = tlaser.project_laser(_scan(tmsg))
    assert tcloud.encode() == jcloud.encode()
    assert tcloud.width > 200


def test_write_tum_same_bytes(tmp_path):
    rng = np.random.default_rng(3)
    poses = []
    for k in range(5):
        pose = synthetic.planar_pose(*rng.normal(size=3))
        pose[2, 3] = rng.normal()
        poses.append((1700000000.0 + 0.1 * k, pose))
    jtum.write_tum(tmp_path / "j.txt", poses)
    ttum.write_tum(tmp_path / "t.txt", poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt"
                                                 ).read_bytes()
    stamps, read = ttum.read_tum(tmp_path / "t.txt")
    assert len(read) == 5 and np.allclose(stamps, [s for s, _ in poses])


@pytest.mark.parametrize("invert", [True, False])
def test_server_messages_match_jax(invert):
    """make_odometry_message / make_tf_message: the same bytes for the same
    result (covariance, tf inversion)."""
    from kinematic_icp_tpu.config import ServerConfig as JServerConfig

    pose = synthetic.planar_pose(2.0, 1.0, -0.7)
    result = {"pose": pose, "twist": np.arange(6.0) / 7, "registered": True}
    kw = dict(invert_odom_tf=invert, position_covariance=0.2)
    js = JServer(JConfig(**CFG), JServerConfig(**kw))
    ts = LidarOdometryServer(Config(**CFG), ServerConfig(**kw), device=CPU)
    stamp = 1700000000.3
    for r in (result, dict(result, twist=None)):
        assert (ts.make_odometry_message(r, stamp).encode()
                == js.make_odometry_message(r, stamp).encode())
        assert (ts.make_tf_message(r, stamp).encode()
                == js.make_tf_message(r, stamp).encode())


def test_load_yaml_config_matches_jax(tmp_path):
    from kinematic_icp_tpu.config import load_yaml_config as jload
    from kinematic_icp_tpu_torch.config import load_yaml_config as tload

    path = tmp_path / "params.yaml"
    path.write_text("kinematic_icp_online_node:\n  ros__parameters:\n"
                    "    max_range: 40.0\n    min_range: 50.0\n"
                    "    voxel_size: 0.5\n    base_frame: base\n"
                    "    stationary_gate: 0.002\n    unknown: 1\n")
    jcfg, jsrv = jload(str(path))
    tcfg, tsrv = tload(str(path))
    assert JConfig(**tcfg.to_jax_dict()) == jcfg
    assert tcfg.min_range == 0.0 and tsrv.base_frame == "base"
    assert dataclasses.asdict(tsrv) == dataclasses.asdict(jsrv)


def test_online_node_matches_jax():
    """One in-memory message stream (the port's messages, crossed to JAX
    through CDR) through both nodes: equal counts and frame ids, poses to
    ROADMAP's rules (the first frames within 1e-5, the drive's ATE well
    under the self-divergence floor)."""
    seq = synthetic.make_sequence(FRAMES)
    stream = synthetic.sequence_messages(seq)
    jstream = [(k, getattr(jmsg, type(m).__name__).decode(m.encode()))
               for k, m in stream]
    outs = {"jax": [], "port": []}
    jnode = JNode(JConfig(**CFG),
                  on_odometry=lambda o, t, r: outs["jax"].append((o, t)))
    tnode = OnlineOdometryNode(
        Config(**CFG), on_odometry=lambda o, t, r: outs["port"].append(
            (o, t)), device=CPU)
    jnode.run(jstream)
    tnode.run(stream)
    js, ts = jnode.server, tnode.server
    assert len(outs["port"]) == len(outs["jax"]) == FRAMES
    assert (ts.frames_registered, ts.frames_skipped) == (
        js.frames_registered, js.frames_skipped) == (FRAMES - 1, 1)
    jposes = np.asarray([p for _, p in js.poses_with_stamps])
    tposes = np.asarray([p for _, p in ts.poses_with_stamps])
    assert [s for s, _ in ts.poses_with_stamps] == [
        s for s, _ in js.poses_with_stamps]
    np.testing.assert_allclose(tposes[:4], jposes[:4], atol=1e-5, rtol=0)
    assert ate_rmse(list(jposes), list(tposes), align=False) < 5e-3
    for (jo, jt), (to, tt) in zip(outs["jax"], outs["port"]):
        assert to.header.frame_id == jo.header.frame_id == "odom_lidar"
        assert to.child_frame_id == jo.child_frame_id == "base_link"
        assert (tt.transforms[0].header.frame_id
                == jt.transforms[0].header.frame_id == "base_link")
        assert to.pose_covariance[0] == jo.pose_covariance[0] == 0.1
        assert np.isfinite(to.position).all()
