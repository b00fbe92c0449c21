"""The offline CLI on a recorded drive: a ROS 2 MCAP bag written by the
benchmark's own writer (``icp_bench/core/rosbag.py``, through the ``bag``
driver) with zstd chunks, begin-stamped per-point times, 50 Hz wheel
odometry on /tf and a mounted LiDAR on /tf_static, run through
``run_odometry.run`` on the CPU and held to the plain reference
(``icp_bench/reference/kicp.py``) on the same arrays; the ingestion
layer's spans and its ``io`` count; the streamed registration bit-equal
to a blocking one and its ``serve`` count; the CLI's defaults; the
decode's field extraction against the numpy path."""

from __future__ import annotations

import inspect
import itertools
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from icp_bench.drivers import bag as bag_driver
from icp_bench.reference import kicp
from kinematic_icp_tpu_torch import Config, run_odometry
from kinematic_icp_tpu_torch import server as tserver
from kinematic_icp_tpu_torch.server import LidarOdometryServer
from kinematic_icp_tpu_torch.utils import profiling
from kinematic_icp_tpu_torch.utils.io import mcap, native, timestamps
from kinematic_icp_tpu_torch.utils.io.bag import (BagMultiplexer,
                                                  BufferableBag,
                                                  decode_message)
from kinematic_icp_tpu_torch.utils.io.messages import (PointCloud2,
                                                       PointField,
                                                       PointFieldType)
from kinematic_icp_tpu_torch.utils.io.tf import TransformBuffer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 8
SEED = 2**31 + 21
#: a 256-column, 12-ring sensor (~1,500 points a scan) and capacities to
#: match, as the benchmark's CPU tests cut ``ros_default``
SMALL = {"max_points": 4096, "max_downsampled": 2048, "max_source": 1024,
         "map_capacity": 1 << 14}
#: the program keeps float32 state and stores map points on a grid of
#: 1/1024 of a voxel (0.98 mm at the 1 m voxel), where the reference keeps
#: float64 points exactly: on this sparse 12-ring drive its poses part from
#: the reference's by up to 1.32 mm (frame 7; 0.02-0.04 mm on two other
#: seeds), the same with the scans handed to ``register_frame`` directly
POSE_TOL_M = 5e-3
#: the TUM file's 6 decimals: 5e-7 m a coordinate
TUM_TOL_M = 1e-6

#: ros/config/kinematic_icp_ros.yaml as the reference ships it
SHIPPED_YAML = """\
/**:
  ros__parameters:
    max_range: 100.0
    min_range: 0.0
    deskew: true
    voxel_size: 1.0
    max_points_per_voxel: 20
    use_adaptive_threshold: true
    fixed_threshold: 1.0
    max_num_iterations: 10
    convergence_criterion: 0.001
    max_num_threads: 1
    use_adaptive_odometry_regularization: true
    fixed_regularization: 0.0
    orientation_covariance: 0.1
    position_covariance: 0.1
"""


def _driver(compression=None, **params):
    config = json.loads((ROOT / "icp_bench" / "configs"
                         / "ros_offline_bag.json").read_text())
    if compression is not None:
        config["bag"]["compression"] = compression
    config["config"].update(SMALL)
    config["sensor"].update({"columns": 256, "rings": 12})
    # chunks of 64 KiB: a few scans each, as the 1 MiB chunks hold one
    # full-size scan
    config["bag"]["chunk_bytes"] = 1 << 16
    config["bag"]["parameters"].update(
        {k: v for k, v in SMALL.items() if k != "max_points"}, **params)
    traffic = json.loads((ROOT / "icp_bench" / "traffic"
                          / "bag300.json").read_text())
    traffic["frames"] = FRAMES
    d = bag_driver.Driver(config, traffic, SEED, 1.0, "cpu")
    d.prepare_inputs()
    return d


@pytest.fixture(scope="module", params=["", "zstd"])
def drive(request, tmp_path_factory):
    """(driver, bag path, parameter file) of the small recorded drive, in
    uncompressed chunks (the benchmark's cell) and in zstd ones (the MCAP
    writer's default)."""
    if request.param == "zstd":
        pytest.importorskip("zstandard")
    tmp = tmp_path_factory.mktemp("bag")
    d = _driver(request.param)
    path = tmp / "drive.mcap"
    d.ends, _, d.size = d.write_bag(path)
    params = tmp / "kinematic_icp_ros.yaml"
    params.write_text(bag_driver.yaml_text(d.config["bag"]["parameters"]))
    return d, path, params


def _args(path, params, out, device="cpu"):
    return run_odometry.build_arg_parser().parse_args(
        [str(path), "--config", str(params), "--output-dir", str(out),
         "--no-progress", "--device", device,
         "--max-points", str(SMALL["max_points"])])


def _run(d, path, params, out, device="cpu"):
    timings = {}
    tum = run_odometry.run(_args(path, params, out, device), timings)
    return tum, timings


@pytest.fixture(scope="module")
def recorded(drive, tmp_path_factory):
    """One run of the CLI inside ``profiling.recording()``: (TUM path,
    timings, the run's [lo, hi] in ns)."""
    d, path, params = drive
    lo = time.time_ns()
    with profiling.recording():
        tum, timings = _run(d, path, params,
                            tmp_path_factory.mktemp("out"))
    return tum, timings, (lo, time.time_ns())


def test_bag_through_the_cli_matches_the_reference(drive, recorded):
    d, _, _ = drive
    tum, timings, _ = recorded
    stamps, poses = bag_driver.read_tum(tum)
    assert len(poses) == FRAMES
    # the scans' end stamps as the reference's TimeStampHandler extends a
    # begin-stamped scan, to the file's 6 decimals
    np.testing.assert_allclose(stamps, d.ends, rtol=0, atol=1e-6)
    cfg = {**d.config["config"], **d.config["reference"]}
    with torch.no_grad():
        ref = kicp.run_drive(d.drive, cfg, "cpu")
    gap = np.linalg.norm(poses[:, :3, 3] - ref[:, :3, 3], axis=1)
    assert gap.max() < POSE_TOL_M, gap
    # the bag's path adds nothing: the same scans, normalised times,
    # odometry and extrinsic handed to the server directly
    server = LidarOdometryServer(
        Config(**{**d.config["config"], "gn_backend": "auto"}),
        extrinsic=d.drive["extrinsic"], device="cpu")
    direct = np.stack([
        server.register_frame(p, t, rel)["pose"] for (p, t), rel in
        zip(d.drive["frames"], d.drive["rel_odometry"])])
    np.testing.assert_allclose(poses[:, :3, 3], direct[:, :3, 3], rtol=0,
                               atol=TUM_TOL_M)
    # the drive moves: the mounted LiDAR and the odometry are not trivial
    assert np.linalg.norm(ref[-1, :2, 3]) > 1.0
    assert timings["frames"] == FRAMES
    assert timings["registered"] == FRAMES - 1  # the first is at rest
    assert timings["overflow"] == 0


def test_the_odometry_between_end_stamps_is_the_drives(drive):
    """The /tf samples make ``lookup_delta_transform`` between two scans'
    end stamps return the drive's odometry (to rounding)."""
    d, path, _ = drive
    tf = TransformBuffer()
    bag = BufferableBag(str(path), tf, "/lidar_points")
    begin = None
    for k, raw in enumerate(bag):
        scan = timestamps.decode_scan(decode_message(raw))
        np.testing.assert_array_equal(scan.points, d.drive["frames"][k][0])
        np.testing.assert_array_equal(scan.timestamps,
                                      d.drive["frames"][k][1])
        assert scan.end == d.ends[k] and scan.frame_id == "lidar"
        begin = scan.stamp if begin is None else begin
        delta = tf.lookup_delta_transform("base_link", begin, scan.end,
                                          "odom")
        np.testing.assert_allclose(delta, d.drive["rel_odometry"][k],
                                   rtol=0, atol=1e-12)
        begin = scan.end
    np.testing.assert_array_equal(
        tf.lookup_transform("base_link", "lidar"), d.drive["extrinsic"])
    assert k == FRAMES - 1 and bag.tf_messages > 5 * FRAMES


def _spans(name, lo, hi):
    return [(t, v["end_ns"]) for t, v in profiling.samples(name, lo, hi)]


def test_ingestion_spans_are_recorded_once_a_message(recorded):
    tum, timings, (lo, hi) = recorded
    read = _spans("kicp.bag_read", lo, hi)
    decode = _spans("kicp.decode", lo, hi)
    tf = _spans("kicp.tf_lookup", lo, hi)
    frame = _spans("kicp.register_frame", lo, hi)
    write = _spans("kicp.write_tum", lo, hi)
    # one read a message, and the last one finds the bag's end
    assert len(read) == FRAMES + 1
    assert len(decode) == len(tf) == FRAMES
    assert len(frame) == FRAMES and len(write) == 1
    # in order a message: read, decode, tf lookup, then its registration,
    # none overlapping; the TUM file after them all
    for k in range(FRAMES):
        assert read[k][1] <= decode[k][0] and decode[k][1] <= tf[k][0]
        assert tf[k][1] <= read[k + 1][0]
    for s, e in frame:
        k = max(i for i in range(FRAMES) if tf[i][1] <= s)
        assert e <= read[k + 1][0]
    assert read[-1][1] <= write[0][0]
    # the server's own spans nest inside its frames
    for s, e in _spans("kicp.pack", lo, hi):
        assert any(a <= s and e <= b for a, b in frame)
    # a chunk's upload in the frame that fills it, or in the drain
    upload = _spans("kicp.upload", lo, hi)
    assert upload and all(any(a <= s and e <= b for a, b in frame + write)
                          for s, e in upload)
    # the streamed frames come back in one read-back, at the TUM file
    back = _spans("kicp.readback", lo, hi)
    assert back and all(write[0][0] <= s and e <= write[0][1]
                        for s, e in back)


def test_one_serve_count_a_run(drive, recorded):
    """One ``serve`` count, at the drain inside ``write_tum``: every
    registered frame streamed, a chunk an upload (one more at each change
    of point bucket) and a wait a chunk's upload, an overflow read every 64
    frames and the drain's read-back."""
    d, _, _ = drive
    tum, timings, (lo, hi) = recorded
    (ws, we), = _spans("kicp.write_tum", lo, hi)
    (t, serve), = profiling.samples("serve", lo, hi)
    assert ws <= t <= we
    frames = serve["frames"]
    assert frames == timings["registered"] == FRAMES - 1
    chunk = inspect.signature(LidarOdometryServer).parameters[
        "stream_chunk"].default
    # the first scan is at rest; a run of one bucket ships in full chunks
    buckets = [tserver.next_bucket(len(p), SMALL["max_points"])
               for p, _ in d.drive["frames"][1:]]
    runs = [sum(1 for _ in g) for _, g in itertools.groupby(buckets)]
    assert serve["flushes"] == sum(math.ceil(n / chunk) for n in runs)
    assert serve["flushes"] + 1 <= serve["waits"] <= (
        serve["flushes"] + frames // 64 + 1)


def _blocking_run(path, params, out, device):
    """The bag read as ``run_odometry.run`` reads it, each scan through
    ``register_scan(..., blocking=True)``: (server, TUM path)."""
    config, server_cfg = run_odometry.configs(_args(path, params, out,
                                                    device))
    server = LidarOdometryServer(config, server_cfg, device=device)
    tf = TransformBuffer()
    mux = BagMultiplexer()
    mux.add_bag(BufferableBag(str(path), tf, "/lidar_points"))
    for raw in mux:
        msg = decode_message(raw)
        if isinstance(msg, PointCloud2):
            assert server.register_scan(timestamps.decode_scan(msg), tf,
                                        blocking=True) is not None
    tum = out / "blocking_poses_tum.txt"
    server.write_tum(tum)
    return server, tum


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_streamed_run_is_bit_equal_to_blocking_frames(drive, device,
                                                      tmp_path, monkeypatch):
    """``run_odometry.run`` streams its scans; a hand loop of the same bag
    through blocking frames gives the same poses bit for bit, the same TUM
    file, ``frame_stats`` and ``overflow_stats`` (on a card, graph
    replays on both sides)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph replays run only there")
    d, path, params = drive
    made = []

    class Recorded(LidarOdometryServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(tserver, "LidarOdometryServer", Recorded)
    tum, timings = _run(d, path, params, tmp_path, device)
    monkeypatch.undo()
    streamed, = made
    blocking, tum_b = _blocking_run(path, params, tmp_path, device)
    assert len(streamed.poses_with_stamps) == FRAMES
    for (s0, p0), (s1, p1) in zip(streamed.poses_with_stamps,
                                  blocking.poses_with_stamps, strict=True):
        assert s0 == s1 and p0.dtype == p1.dtype == np.float64
        np.testing.assert_array_equal(p0, p1)
    assert Path(tum).read_bytes() == tum_b.read_bytes()
    assert streamed.frame_stats == blocking.frame_stats
    assert streamed.frame_stats["frames"] == timings["registered"]
    assert streamed.overflow_stats == blocking.overflow_stats
    assert streamed.frames_skipped == blocking.frames_skipped == 1


def test_one_io_count_a_run(drive, recorded):
    d, path, _ = drive
    tum, timings, (lo, hi) = recorded
    (t, io), = profiling.samples("io", lo, hi)
    assert io["messages"] == timings["frames"] == FRAMES
    with mcap.McapReader(str(path)) as r:
        counts = {}
        for m in r.messages():
            counts[m.channel.topic] = counts.get(m.channel.topic, 0) + 1
        assert io["chunks"] == r.chunks > 2
    assert io["tf_messages"] == counts["/tf"] + counts["/tf_static"]
    # every record up to the footer's
    assert d.size - 64 < io["bytes_in"] <= d.size
    assert io["bytes_out"] == Path(tum).stat().st_size


def test_nothing_is_recorded_outside_recording(drive, tmp_path):
    d, path, params = drive
    before = [len(profiling.samples(n)) for n in ("kicp.bag_read", "serve")]
    _run(d, path, params, tmp_path)
    assert [len(profiling.samples(n))
            for n in ("kicp.bag_read", "serve")] == before


def test_overflow_total_reaches_the_timings(tmp_path):
    """A source capacity the scans overflow: the CLI hands the server's
    total out."""
    d = _driver(max_source=64)
    path = tmp_path / "drive.mcap"
    d.write_bag(path)
    params = tmp_path / "params.yaml"
    params.write_text(bag_driver.yaml_text(d.config["bag"]["parameters"]))
    with pytest.warns(RuntimeWarning, match="capacity overflow"):
        _, timings = _run(d, path, params, tmp_path)
    assert timings["overflow"] > 0


def test_defaults_are_the_shipped_parameter_files(tmp_path):
    pytest.importorskip("yaml")
    shipped = tmp_path / "kinematic_icp_ros.yaml"
    shipped.write_text(SHIPPED_YAML)
    parse = run_odometry.build_arg_parser().parse_args
    assert (run_odometry.configs(parse(["x.mcap"]))
            == run_odometry.configs(parse(["x.mcap", "--config",
                                           str(shipped)])))


def _cloud(stamps, dtype, xyz_type=PointFieldType.FLOAT32, step_pad=2):
    """A cloud with x, y, z, a uint16 ring and ``stamps`` of ``dtype`` at
    an unaligned offset."""
    rng = np.random.default_rng(5)
    n = len(stamps)
    xyz_dt = {PointFieldType.FLOAT32: "<f4", PointFieldType.FLOAT64: "<f8"
              }[xyz_type]
    w = np.dtype(xyz_dt).itemsize
    t_dt = np.dtype(dtype)
    fields = [PointField("x", 0, xyz_type), PointField("y", w, xyz_type),
              PointField("z", 2 * w, xyz_type),
              PointField("ring", 3 * w, PointFieldType.UINT16),
              PointField("time", 3 * w + step_pad,
                         {np.dtype("<f4"): PointFieldType.FLOAT32,
                          np.dtype("<f8"): PointFieldType.FLOAT64,
                          np.dtype("<u4"): PointFieldType.UINT32}[t_dt])]
    rec = np.zeros(n, np.dtype({"names": ["x", "y", "z", "ring", "time"],
                                "formats": [xyz_dt] * 3 + ["<u2", t_dt],
                                "offsets": [f.offset for f in fields],
                                "itemsize": 3 * w + step_pad
                                + t_dt.itemsize}))
    for c in "xyz":
        rec[c] = rng.normal(0, 10, n)
    rec["time"] = stamps
    return PointCloud2(fields=fields, width=n, point_step=rec.itemsize,
                       row_step=rec.itemsize * n, data=rec.tobytes())


@pytest.mark.parametrize("stamps, dtype", [
    (np.linspace(0, 0.1, 500), "<f4"),                  # seconds
    (np.arange(500) * 200_000, "<u4"),                  # ns from the start
    (1_724_411_141 + np.linspace(0, 0.1, 500), "<f8"),  # absolute s
    (1_724_411_141e9 + np.arange(500) * 2e5, "<f8"),    # absolute ns
    (np.linspace(-0.1, 0, 500), "<f4"),                 # stamped at the end
])
def test_one_pass_extraction_equals_the_numpy_path(stamps, dtype,
                                                   monkeypatch):
    """``decode_scan`` (the native points, each stamp read by
    ``field_array``'s strided copy of its unaligned field) against the
    record array's own fields, the numpy points and
    ``TimeStampHandler``."""
    if native.get_lib() is None:
        pytest.skip("the native library does not build on this host")
    cloud = _cloud(stamps, dtype)
    rec = np.frombuffer(cloud.data, np.dtype({
        "names": [f.name for f in cloud.fields],
        "formats": [cloud.field_array(f.name).dtype for f in cloud.fields],
        "offsets": [f.offset for f in cloud.fields],
        "itemsize": cloud.point_step}))
    for f in cloud.fields:
        np.testing.assert_array_equal(cloud.field_array(f.name), rec[f.name])
    scan = timestamps.decode_scan(cloud)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(scan.points, cloud.xyz())
    handler = timestamps.TimeStampHandler()
    begin, end, norm = handler.process_timestamps(cloud)
    assert scan.end == end
    np.testing.assert_array_equal(scan.timestamps, norm)


def test_extraction_of_float64_points_and_without_stamps():
    cloud = _cloud(np.zeros(10), "<f4", xyz_type=PointFieldType.FLOAT64)
    xyz = timestamps.decode_scan(cloud).points
    assert xyz.dtype == np.float32 and xyz.shape == (10, 3)
    cloud.fields = cloud.fields[:4]
    scan = timestamps.decode_scan(cloud)
    assert scan.timestamps is None and scan.end == scan.stamp
    assert np.array_equal(scan.points, xyz)
    empty = _cloud(np.zeros(0), "<f8")
    assert empty.field_array("time").shape == (0,)
    assert timestamps.decode_scan(empty).points.shape == (0, 3)
