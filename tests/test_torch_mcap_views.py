"""The MCAP reader hands each message to the decode as a view of what it
read: the record's file read, or its chunk's decompressed output.

One small 128-ring drive (the benchmark's ``bag_hesai`` driver: 26-byte
points, the float64 ``timestamp`` at offset 18, 50 Hz /tf) in three
layouts: uncompressed chunks (``icp_bench/core/rosbag.py``, as the bag
cells write them, a scan a chunk), no chunks and lz4 chunks (the port's
``McapWriter``, the same messages).  Each message's bytes equal those a
plain ``bytes``-slicing reader cuts from the file, and decode to the same
bits; an uncompressed scan's points share memory with the buffer the
reader read; scans held in ``BufferableBag`` while the rest of the bag is
read decode unchanged; ``bytes_copied`` reads 0, in the reader and in the
offline node's ``io`` count."""

from __future__ import annotations

import gc
import io
import json
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from icp_bench.drivers import bag_hesai
from kinematic_icp_tpu_torch import run_odometry
from kinematic_icp_tpu_torch.utils import profiling
from kinematic_icp_tpu_torch.utils.io import lz4f, mcap
from kinematic_icp_tpu_torch.utils.io.bag import BufferableBag, decode_message
from kinematic_icp_tpu_torch.utils.io.messages import PointCloud2, TFMessage
from kinematic_icp_tpu_torch.utils.io.tf import TransformBuffer
from kinematic_icp_tpu_torch.utils.io.timestamps import decode_scan

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 4
SEED = 2**31 + 26
TOPIC = "/lidar_points"
#: 128 rings × 48 columns (~4,400 points, ~115 KB a scan)
SENSOR = {"columns": 48, "rings": 128}
SMALL = {"max_points": 8192, "max_downsampled": 4096, "max_source": 2048,
         "map_capacity": 1 << 15}
#: chunks of 64 KiB: each scan closes a chunk of its own, with the /tf
#: messages before it
CHUNK_BYTES = 1 << 16
LAYOUTS = ["chunks", "no_chunks", "lz4"]


def _plain_messages(path):
    """(topic, schema name, log time, data) of every message, each cut
    from the file's bytes by plain ``bytes`` slicing."""
    schemas, channels, out = {}, {}, []

    def walk(buf, pos):
        while pos + 9 <= len(buf):
            op = buf[pos]
            n, = struct.unpack_from("<Q", buf, pos + 1)
            rec = buf[pos + 9:pos + 9 + n]
            pos += 9 + n
            if op == mcap.OP_FOOTER:
                return
            if op == mcap.OP_SCHEMA:
                sid, k = struct.unpack_from("<HI", rec)
                schemas[sid] = rec[6:6 + k].decode()
            elif op == mcap.OP_CHANNEL:
                cid, sid, k = struct.unpack_from("<HHI", rec)
                channels[cid] = (rec[8:8 + k].decode(), sid)
            elif op == mcap.OP_MESSAGE:
                cid, _, log_time, _ = struct.unpack_from("<HIQQ", rec)
                topic, sid = channels[cid]
                out.append((topic, schemas[sid], log_time, rec[22:]))
            elif op == mcap.OP_CHUNK:
                k, = struct.unpack_from("<I", rec, 28)
                compression = rec[32:32 + k].decode()
                rlen, = struct.unpack_from("<Q", rec, 32 + k)
                payload = rec[40 + k:40 + k + rlen]
                walk(lz4f.decompress_frame(payload)
                     if compression == "lz4" else payload, 0)

    walk(Path(path).read_bytes(), len(mcap.MAGIC))
    return out


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """(bag paths by layout, parameter file, messages of the drive)."""
    tmp = tmp_path_factory.mktemp("views")
    config = json.loads((ROOT / "icp_bench" / "configs"
                         / "pandar128_bag.json").read_text())
    config["config"].update(SMALL)
    config["sensor"].update(SENSOR)
    config["bag"]["chunk_bytes"] = CHUNK_BYTES
    config["bag"]["parameters"].update(
        {k: v for k, v in SMALL.items() if k != "max_points"})
    assert config["bag"]["compression"] == ""
    traffic = json.loads((ROOT / "icp_bench" / "traffic"
                          / "bag150.json").read_text())
    traffic["frames"] = FRAMES
    d = bag_hesai.Driver(config, traffic, SEED, 1.0, "cpu")
    d.prepare_inputs()
    paths = {"chunks": tmp / "chunks.mcap"}
    d.write_bag(paths["chunks"])
    messages = _plain_messages(paths["chunks"])
    for layout, compression in (("no_chunks", ""), ("lz4", "lz4")):
        paths[layout] = tmp / f"{layout}.mcap"
        with mcap.McapWriter(str(paths[layout]),
                             compression=compression) as w:
            w.chunk_size = CHUNK_BYTES
            for topic, schema, log_time, data in messages:
                w.write_message(topic, schema, data, log_time)
    params = tmp / "kinematic_icp_ros.yaml"
    params.write_text(bag_hesai.yaml_text(config["bag"]["parameters"]))
    return paths, params, messages


def _assert_same_scan(a, b):
    assert a.points.dtype == b.points.dtype == np.float32
    np.testing.assert_array_equal(a.points, b.points)
    assert a.timestamps.dtype == b.timestamps.dtype == np.float32
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert (a.stamp, a.end, a.frame_id) == (b.stamp, b.end, b.frame_id)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_message_is_the_plain_readers_bytes_and_decodes_alike(
        drive, layout):
    paths, _, messages = drive
    with mcap.McapReader(str(paths[layout])) as r:
        ours = list(r.messages())
    assert [(m.channel.topic, m.schema.name, m.log_time) for m in ours] == \
        [m[:3] for m in messages]
    scans = 0
    for m, (topic, _, _, data) in zip(ours, messages, strict=True):
        assert isinstance(m.data, memoryview)
        assert bytes(m.data) == data
        if topic != TOPIC:
            ours_tf, plain_tf = TFMessage.decode(m.data), TFMessage.decode(
                data)
            assert len(ours_tf.transforms) == len(plain_tf.transforms) == 1
            for a, b in zip(ours_tf.transforms, plain_tf.transforms):
                assert a.header == b.header
                assert a.child_frame_id == b.child_frame_id
                np.testing.assert_array_equal(a.translation, b.translation)
                np.testing.assert_array_equal(a.rotation, b.rotation)
            continue
        scans += 1
        cloud = decode_message(m)
        assert isinstance(cloud.data, memoryview)
        _assert_same_scan(decode_scan(cloud), decode_scan(
            PointCloud2.decode(bytes(m.data))))
    assert scans == FRAMES


class _RecordingFile(io.BytesIO):
    """A file whose ``read`` results are kept, to find what a view is of."""

    def __init__(self, data):
        super().__init__(data)
        self.reads = []

    def read(self, n=-1):
        out = super().read(n)
        self.reads.append(out)
        return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_scans_points_are_a_view_of_what_the_reader_read(drive, layout):
    """Uncompressed, a scan's points share memory with the one file read
    of its chunk or record; in lz4 chunks, with the chunk's decompressed
    output, which is no file read."""
    paths, _, _ = drive
    f = _RecordingFile(paths[layout].read_bytes())
    scans = 0
    with mcap.McapReader(f) as r:
        for m in r.messages([TOPIC]):
            cloud = decode_message(m)
            points = np.frombuffer(cloud.data, np.uint8)
            assert len(points) == cloud.row_step * cloud.height > 0
            owners = [b for b in f.reads
                      if np.shares_memory(points, np.frombuffer(b, np.uint8))]
            if layout == "lz4":
                assert owners == []
                assert np.shares_memory(points, np.frombuffer(m.data.obj,
                                                              np.uint8))
            else:
                assert len(owners) == 1 and m.data.obj is owners[0]
                assert len(owners[0]) > len(cloud.data)
            scans += 1
    assert scans == FRAMES


@pytest.mark.parametrize("layout", LAYOUTS)
def test_scans_held_while_the_rest_of_the_bag_is_read_decode_unchanged(
        drive, layout):
    paths, _, messages = drive
    plain = [data for topic, _, _, data in messages if topic == TOPIC]
    n_tf = sum(topic != TOPIC for topic, _, _, _ in messages)
    # a look-ahead longer than the drive: the whole bag is read (every
    # /tf message replayed) before the first scan leaves the buffer
    bag = BufferableBag(str(paths[layout]), TransformBuffer(), TOPIC,
                        buffer_size=60.0)
    held = [bag.pop_next_message()]
    assert bag.tf_messages == n_tf
    held += list(bag)
    gc.collect()
    churn = [bytes(len(m.data)) for m in held]  # reuse what was freed
    assert len(held) == len(plain) == FRAMES
    for m, data in zip(held, plain, strict=True):
        _assert_same_scan(decode_scan(decode_message(m)),
                          decode_scan(PointCloud2.decode(data)))
    del churn


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_reader_copies_no_payload_byte(drive, layout):
    paths, _, messages = drive
    with mcap.McapReader(str(paths[layout])) as r:
        assert sum(1 for _ in r.messages()) == len(messages)
        assert r.bytes_copied == 0
        assert (r.chunks >= FRAMES) == (layout != "no_chunks")


def test_bytes_copied_counts_a_cut_that_copies(drive):
    paths, _, _ = drive
    with mcap.McapReader(str(paths["chunks"])) as r:
        assert r._cut(memoryview(b"abcdef"), 1, 4) == b"bcd"
        assert r.bytes_copied == 0
        assert r._cut(b"abcdef", 1, 4) == b"bcd"
        assert r._cut(b"abcdef", 2) == b"cdef"
        assert r.bytes_copied == 7


def test_the_offline_nodes_io_count_carries_bytes_copied(drive, tmp_path):
    paths, params, _ = drive
    argv = ["--config", str(params), "--output-dir", str(tmp_path),
            "--no-progress", "--device", "cpu",
            "--max-points", str(SMALL["max_points"]), str(paths["chunks"])]
    timings = {}
    lo = time.time_ns()
    with profiling.recording():
        run_odometry.main(argv, timings)
    (_, counts), = profiling.samples("io", lo, time.time_ns())
    assert counts["messages"] == timings["frames"] == FRAMES
    assert counts["chunks"] >= FRAMES
    assert counts["bytes_copied"] == 0
