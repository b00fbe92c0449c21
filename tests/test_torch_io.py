"""Port vs JAX: the bag ingestion layer (lz4 frames, mcap, rosbag2 sqlite,
the buffered bag reader) and the native ingestion bindings."""

import io
import struct

import numpy as np
import pytest
import torch

from kinematic_icp_tpu.utils import synthetic as jsyn
from kinematic_icp_tpu.utils.io import bag as jbag
from kinematic_icp_tpu.utils.io import lz4f as jlz4
from kinematic_icp_tpu.utils.io import mcap as jmcap
from kinematic_icp_tpu.utils.io import messages as jmsg
from kinematic_icp_tpu.utils.io import native as jnative
from kinematic_icp_tpu.utils.io import sqlite_bag as jsql
from kinematic_icp_tpu.utils.io import tf as jtf
from kinematic_icp_tpu.utils.io.laserscan import project_laser as jproject
from kinematic_icp_tpu_torch.utils import progress, synthetic
from kinematic_icp_tpu_torch.utils.io import bag, lz4f, mcap, messages, native
from kinematic_icp_tpu_torch.utils.io import sqlite_bag, tf
from kinematic_icp_tpu_torch.utils.io.laserscan import project_laser

torch.set_num_threads(1)

RNG = np.random.default_rng(7)
PAYLOADS = [b"", b"x", b"hello world " * 100,
            bytes(RNG.integers(0, 256, 5000, dtype=np.uint8)),
            bytes(RNG.integers(0, 256, 100_000, dtype=np.uint8))]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_lz4_frames_byte_identical_and_cross_decoded(i):
    data = PAYLOADS[i]
    assert lz4f.compress_block(data) == jlz4.compress_block(data)
    frame = lz4f.compress_frame(data)
    assert frame == jlz4.compress_frame(data)
    assert lz4f.decompress_frame(frame) == jlz4.decompress_frame(frame) \
        == data


def test_lz4_linked_blocks_decode_like_jax():
    """A block-linked frame (liblz4's default: a match reaching back into
    the previous block), and the same bytes as an independent frame, which
    both packages refuse."""
    frame = bytearray(struct.pack("<I", lz4f.FRAME_MAGIC))
    frame += bytes([0x40, 0x40, 0x00])              # v1, linked, 64K, hc
    for block in (bytes([0x80]) + b"abcdefgh", bytes([0x04, 0x08, 0x00])):
        frame += struct.pack("<I", len(block)) + block
    frame += struct.pack("<I", 0)
    assert lz4f.decompress_frame(bytes(frame)) == jlz4.decompress_frame(
        bytes(frame)) == b"abcdefgh" * 2
    frame[4] = 0x60                                 # independent blocks
    for mod in (lz4f, jlz4):
        with pytest.raises(ValueError, match="history"):
            mod.decompress_frame(bytes(frame))


def _write_messages(writer_cls, compression):
    """A small mixed bag through ``writer_cls``; returns its bytes."""
    buf = io.BytesIO()
    w = writer_cls(buf, compression=compression)
    w.chunk_size = 2000  # several chunks
    pts = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    cloud = messages.PointCloud2.from_xyz(pts, stamp=2.0, frame_id="lidar")
    for i in range(4):
        w.write_message("/points", "sensor_msgs/msg/PointCloud2",
                        cloud.encode(), int((2.0 + 0.1 * i) * 1e9))
        w.write_message("/tf", "tf2_msgs/msg/TFMessage",
                        messages.TFMessage().encode(), int(2.05e9 + i))
    w.close()
    return buf.getvalue()


def _records(reader):
    return [(m.channel.topic, m.schema.name, m.log_time, m.publish_time,
             m.sequence, m.data) for m in reader.messages()]


@pytest.mark.parametrize("compression", ["", "lz4", "zstd"])
def test_mcap_byte_identical_and_cross_read(compression):
    port = _write_messages(mcap.McapWriter, compression)
    assert port == _write_messages(jmcap.McapWriter, compression)
    theirs = _records(jmcap.McapReader(io.BytesIO(port)))
    ours = _records(mcap.McapReader(io.BytesIO(port)))
    assert ours == theirs and len(ours) == 8
    reader = mcap.McapReader(io.BytesIO(port))
    assert reader.count_messages("/points") == 4
    assert [m.channel.topic for m in reader.messages(["/tf"])] == ["/tf"] * 4


@pytest.fixture(scope="module")
def drive_bags(tmp_path_factory):
    """Two short drives written by each package's writer (3D scans and a
    LaserScan topic)."""
    d = tmp_path_factory.mktemp("io")
    out = {}
    for name, n, seed in (("a", 4, 0), ("b", 3, 5)):
        seq = synthetic.make_sequence(n, traj_seed=seed)
        for pkg, writer in (("port", synthetic), ("jax", jsyn)):
            path = str(d / f"{pkg}_{name}.mcap")
            writer.write_sequence_to_mcap(seq, path,
                                          scan_2d_topic="/front_scan")
            out[pkg, name] = path
    return out


def test_synthetic_bag_byte_identical_to_jax(drive_bags):
    for name in ("a", "b"):
        with open(drive_bags["port", name], "rb") as f:
            port = f.read()
        with open(drive_bags["jax", name], "rb") as f:
            assert f.read() == port


def test_render_2d_scan_equals_jax():
    seq = synthetic.make_sequence(2)
    pose = seq["gt_poses"][1] @ seq["extrinsic"]
    ours = synthetic.render_2d_scan(seq["world"], pose,
                                    rng=np.random.default_rng(4))
    theirs = jsyn.render_2d_scan(jsyn.SyntheticWorld(seed=0), pose,
                                 rng=np.random.default_rng(4))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def _sqlite_bytes(mod, path):
    with mod.SqliteBagWriter(path) as w:
        for i in range(5):
            t = 1.0 + 0.1 * i
            tfm = messages.TFMessage([messages.TransformStamped.from_matrix(
                synthetic.planar_pose(0.1 * i, 0.0, 0.01 * i), t, "odom",
                "base")])
            w.write_message("/tf", "tf2_msgs/msg/TFMessage", tfm.encode(),
                            int(t * 1e9))
            cloud = messages.PointCloud2.from_xyz(
                np.full((10, 3), i, np.float32), stamp=t, frame_id="lidar")
            w.write_message("/scan", "sensor_msgs/msg/PointCloud2",
                            cloud.encode(), int(t * 1e9))
    with open(path, "rb") as f:
        return f.read()


def test_sqlite_bag_byte_identical_and_cross_read(tmp_path):
    port = _sqlite_bytes(sqlite_bag, str(tmp_path / "port.db3"))
    assert port == _sqlite_bytes(jsql, str(tmp_path / "jax.db3"))
    for path in (tmp_path / "port.db3", tmp_path / "jax.db3"):
        with sqlite_bag.SqliteBagReader(str(path)) as ours, \
                jsql.SqliteBagReader(str(path)) as theirs:
            assert _records(ours) == _records(theirs)
            assert len(_records(ours)) == 10
            assert ours.count_messages("/scan") == theirs.count_messages(
                "/scan") == 5
            assert [m.channel.topic for m in ours.messages(["/tf"])] == \
                ["/tf"] * 5
    assert isinstance(sqlite_bag.open_bag(str(tmp_path / "port.db3")),
                      sqlite_bag.SqliteBagReader)


def _drain(bag_mod, tf_mod, paths, topic, buffer_size):
    """Both bags chained through ``bag_mod``; returns the delivered
    messages and, after each, samples of the tf state."""
    tfb = tf_mod.TransformBuffer()
    mux = bag_mod.BagMultiplexer()
    for p in paths:
        mux.add_bag(bag_mod.BufferableBag(p, tfb, topic,
                                          buffer_size=buffer_size))
    out = []
    for m in mux:
        t = m.log_time_sec
        state = [tfb.frame_exists(f) for f in ("odom", "base_link", "lidar")]
        if all(state):
            state += [tfb.lookup_transform("odom", "base_link", t + dt)
                      .tobytes() for dt in (-0.05, 0.0, 0.2)]
            state.append(tfb.lookup_transform("base_link", "lidar", t)
                         .tobytes())
        out.append((m.channel.topic, m.log_time, m.data, state,
                    type(bag_mod.decode_message(m)).__name__))
    return out, mux.message_count()


@pytest.mark.parametrize("topic", ["/lidar_points", "/front_scan"])
@pytest.mark.parametrize("buffer_size", [0.3, 1.0])
def test_buffered_bags_same_order_and_tf_state_as_jax(drive_bags, topic,
                                                      buffer_size):
    paths = [drive_bags["port", "a"], drive_bags["port", "b"]]
    ours, n = _drain(bag, tf, paths, topic, buffer_size)
    theirs, jn = _drain(jbag, jtf, paths, topic, buffer_size)
    assert n == jn == 7 and len(ours) == 7
    assert ours == theirs
    assert all(len(s[3]) == 7 for s in ours)  # tf was ahead of every scan


def test_decode_message_refuses_unknown_schema():
    m = mcap.Message(mcap.Channel(0, 1, "/x", "cdr"),
                     mcap.Schema(1, "foo/msg/Bar", "ros2msg", b""), 0, 0, 0,
                     b"")
    with pytest.raises(ValueError, match="unsupported schema"):
        bag.decode_message(m)


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's numpy fallbacks, as on a host without a compiler."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


def test_native_library_builds_here_not_in_native():
    lib = native.get_lib()
    assert lib is not None
    assert native.artifact_path("kicp_io").parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"


@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT64"])
def test_native_xyz_bit_equal_to_numpy_and_jax(dtype, monkeypatch):
    pts = (RNG.normal(size=(500, 3)) * 20).astype(np.float32)
    ts = RNG.uniform(0, 0.1, 500)
    code = getattr(messages.PointFieldType, dtype)
    msg = messages.PointCloud2.from_xyz(pts, timestamps=ts,
                                        timestamp_field="t",
                                        timestamp_type=code)
    jm = jmsg.PointCloud2.decode(msg.encode())
    native_xyz = msg.xyz()
    assert native.get_lib() is not None
    np.testing.assert_array_equal(native_xyz, pts)
    np.testing.assert_array_equal(native_xyz, jm.xyz())
    f = msg.field("t")
    ours = native.extract_pointcloud(msg.data, 500, msg.point_step, 0, 4, 8,
                                     messages.PointFieldType.FLOAT32,
                                     f.offset, f.datatype)
    theirs = jnative.extract_pointcloud(msg.data, 500, msg.point_step, 0, 4,
                                        8, messages.PointFieldType.FLOAT32,
                                        f.offset, f.datatype)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(msg.xyz(), native_xyz)


def _scan(n=360):
    """A LaserScan as a bag delivers it (its float32 fields decoded)."""
    return _wire(messages.LaserScan(

        header=messages.Header(messages.Time.from_sec(1.0), "laser"),
        angle_min=-np.pi, angle_max=np.pi, angle_increment=2 * np.pi / n,
        time_increment=1e-4, scan_time=0.036, range_min=0.5, range_max=25.0,
        ranges=np.where(RNG.uniform(size=n) < 0.1, np.inf,
                        RNG.uniform(1, 20, n)).astype(np.float32),
        intensities=np.zeros(n, np.float32)))


def _wire(scan):
    return messages.LaserScan.decode(scan.encode())


def test_native_project_laser_equals_jax_and_numpy(monkeypatch):
    """The native loop is bit-equal to JAX's (the same source and flags);
    it projects in float32 where the numpy path takes float64, so it agrees
    with the numpy path to JAX's own bound (tests/test_native.py:64-68)."""
    scan = _scan()
    jscan = jmsg.LaserScan.decode(scan.encode())
    ours = project_laser(scan)
    theirs = jproject(jscan)
    assert native.get_lib() is not None and jnative.get_lib() is not None
    assert ours.encode() == theirs.encode()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = project_laser(scan)
    np.testing.assert_allclose(ours.xyz(), plain.xyz(), atol=1e-5)
    np.testing.assert_allclose(ours.field_array("stamps"),
                               plain.field_array("stamps"), atol=1e-9)


def test_numpy_project_laser_equals_jax_numpy_path(numpy_only, monkeypatch):
    scan = _scan(200)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert project_laser(scan).encode() == jproject(
        jmsg.LaserScan.decode(scan.encode())).encode()


def test_extract_refuses_short_data():
    with pytest.raises(ValueError, match="fewer than"):
        native.extract_pointcloud(b"\0" * 23, 2, 12, 0, 4, 8,
                                  messages.PointFieldType.FLOAT32)


def test_progress_bar_renders_counts():
    out = io.StringIO()
    with progress.ProgressBar(4, desc="kicp", stream=out,
                              min_interval=0.0) as bar:
        for _ in range(4):
            bar.update()
    text = out.getvalue()
    assert "kicp [" in text and "4/4" in text and text.endswith("\n")
