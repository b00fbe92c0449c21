"""A minimal writer of ROS 2 bags in MCAP, for the benchmark's recorded
drives.

Written from the MCAP specification (format version 0, mcap.dev/spec) and
the CDR encoding ROS 2 serialises messages with (OMG XCDR1, little
endian); it imports nothing of the program, so that a change to the
program cannot change its inputs.  It writes what ``ros2 bag record``
with the MCAP storage plugin writes for the topics it is given: a Header,
Schema and Channel records, the messages in Chunks compressed with zstd
or left uncompressed and closed once they hold ``chunk_bytes`` (the MCAP
library's defaults: zstd, 1 MiB), a MessageIndex record after each chunk,
and a summary section (Schema, Channel, Statistics and ChunkIndex
records) from which a reader counts the messages of a topic.  Frozen: a
later change adds a writer beside it and edits nothing here.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"\x89MCAP0\r\n"
OP_HEADER, OP_FOOTER, OP_SCHEMA, OP_CHANNEL = 0x01, 0x02, 0x03, 0x04
OP_MESSAGE, OP_CHUNK, OP_MESSAGE_INDEX, OP_CHUNK_INDEX = 0x05, 0x06, 0x07, 0x08
OP_STATISTICS, OP_DATA_END = 0x0B, 0x0F

POINTCLOUD2 = "sensor_msgs/msg/PointCloud2"
TFMESSAGE = "tf2_msgs/msg/TFMessage"
#: sensor_msgs/PointField datatypes
FLOAT32, UINT16 = 7, 4


def _string(s: str) -> bytes:
    raw = s.encode()
    return struct.pack("<I", len(raw)) + raw


def _record(op: int, body: bytes) -> bytes:
    return struct.pack("<BQ", op, len(body)) + body


class Cdr:
    """CDR (XCDR1, little endian) serialisation of one message: each
    primitive aligned to its size from the end of the 4-byte
    encapsulation header."""

    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")

    def _align(self, size: int):
        pad = -(len(self.buf) - 4) % size
        self.buf += b"\x00" * pad

    def put(self, fmt: str, *values):
        """``values`` packed by ``fmt`` (one primitive type, repeated),
        aligned to that type's size."""
        self._align(struct.calcsize(fmt.lstrip("0123456789")[0]))
        self.buf += struct.pack("<" + fmt, *values)

    def string(self, s: str):
        raw = s.encode() + b"\x00"
        self.put("I", len(raw))
        self.buf += raw

    def stamp(self, sec: int, nanosec: int, frame_id: str):
        """A std_msgs/Header."""
        self.put("iI", sec, nanosec)
        self.string(frame_id)

    def value(self) -> bytes:
        return bytes(self.buf)


def pointcloud2(sec: int, nanosec: int, frame_id: str, fields, points):
    """A sensor_msgs/PointCloud2 of one row: ``fields`` (name, offset,
    datatype) and ``points`` a structured numpy array whose itemsize is
    the point step."""
    c = Cdr()
    c.stamp(sec, nanosec, frame_id)
    c.put("II", 1, len(points))
    c.put("I", len(fields))
    for name, offset, datatype in fields:
        c.string(name)
        c.put("I", offset)
        c.put("B", datatype)
        c.put("I", 1)
    step = points.dtype.itemsize
    c.put("B", 0)                                   # is_bigendian
    c.put("II", step, step * len(points))
    data = points.tobytes()
    c.put("I", len(data))
    c.buf += data
    c.put("B", 1)                                   # is_dense
    return c.value()


def tf_message(transforms):
    """A tf2_msgs/TFMessage of (sec, nanosec, parent, child, translation
    (3,), quaternion (x, y, z, w)) transforms."""
    c = Cdr()
    c.put("I", len(transforms))
    for sec, nanosec, parent, child, t, q in transforms:
        c.stamp(sec, nanosec, parent)
        c.string(child)
        c.put("3d", *map(float, t))
        c.put("4d", *map(float, q))
    return c.value()


class McapWriter:
    """``write(topic, schema, data, log_time_ns)`` in log-time order, then
    ``close()``; as a context manager, closed at the block's end (the file
    left unfinished where the block raised)."""

    def __init__(self, path, compression: str = "zstd",
                 chunk_bytes: int = 1 << 20, library: str = "icp_bench"):
        if compression not in ("zstd", ""):
            raise ValueError(f"chunk compression {compression!r}")
        self.f = open(path, "wb")
        self.compression = compression
        self.chunk_bytes = int(chunk_bytes)
        self.schemas: dict[str, int] = {}
        self.channels: dict[str, tuple[int, bytes]] = {}
        self.schema_records: list[bytes] = []
        self.counts: dict[int, int] = {}
        self.chunk_indexes: list[bytes] = []
        self.times: list[int] = []
        self.bytes_out = 0
        self._chunk = bytearray()
        self._index: dict[int, list[tuple[int, int]]] = {}
        self._chunk_times: list[int] = []
        self._zstd = None
        if compression == "zstd":
            import zstandard
            self._zstd = zstandard.ZstdCompressor()
        self.f.write(MAGIC)
        self.f.write(_record(OP_HEADER, _string("ros2") + _string(library)))

    def _channel(self, topic: str, schema: str) -> int:
        if topic not in self.channels:
            if schema not in self.schemas:
                sid = len(self.schemas) + 1
                self.schemas[schema] = sid
                rec = _record(OP_SCHEMA, struct.pack("<H", sid)
                              + _string(schema) + _string("ros2msg")
                              + struct.pack("<I", 0))
                self.schema_records.append(rec)
                self.f.write(rec)
            cid = len(self.channels)
            rec = _record(OP_CHANNEL, struct.pack(
                "<HH", cid, self.schemas[schema]) + _string(topic)
                + _string("cdr") + struct.pack("<I", 0))
            self.channels[topic] = (cid, rec)
            self.f.write(rec)
        return self.channels[topic][0]

    def write(self, topic: str, schema: str, data: bytes, log_time_ns: int):
        cid = self._channel(topic, schema)
        seq = self.counts.get(cid, 0)
        self.counts[cid] = seq + 1
        self._index.setdefault(cid, []).append((log_time_ns,
                                                len(self._chunk)))
        self._chunk += _record(OP_MESSAGE, struct.pack(
            "<HIQQ", cid, seq, log_time_ns, log_time_ns) + data)
        self._chunk_times.append(log_time_ns)
        self.times.append(log_time_ns)
        self.bytes_out += len(data)
        if len(self._chunk) >= self.chunk_bytes:
            self._flush()

    def _flush(self):
        if not self._chunk:
            return
        records = bytes(self._chunk)
        payload = (self._zstd.compress(records) if self._zstd is not None
                   else records)
        t0, t1 = min(self._chunk_times), max(self._chunk_times)
        start = self.f.tell()
        chunk = _record(OP_CHUNK, struct.pack("<QQQI", t0, t1, len(records),
                                              0)
                        + _string(self.compression)
                        + struct.pack("<Q", len(payload)) + payload)
        self.f.write(chunk)
        index_start = self.f.tell()
        offsets = b""
        for cid, entries in sorted(self._index.items()):
            body = b"".join(struct.pack("<QQ", t, o) for t, o in entries)
            rec = _record(OP_MESSAGE_INDEX, struct.pack("<H", cid)
                          + struct.pack("<I", len(body)) + body)
            offsets += struct.pack("<HQ", cid, self.f.tell())
            self.f.write(rec)
        end = self.f.tell()
        self.chunk_indexes.append(_record(OP_CHUNK_INDEX, struct.pack(
            "<QQQQ", t0, t1, start, len(chunk))
            + struct.pack("<I", len(offsets)) + offsets
            + struct.pack("<Q", end - index_start)
            + _string(self.compression)
            + struct.pack("<QQ", len(payload), len(records))))
        self._chunk = bytearray()
        self._index = {}
        self._chunk_times = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.f.close()

    def close(self) -> int:
        """Writes the summary and the footer; returns the file's size
        (also kept as ``size``)."""
        self._flush()
        self.f.write(_record(OP_DATA_END, struct.pack("<I", 0)))
        summary = self.f.tell()
        for rec in self.schema_records:
            self.f.write(rec)
        for _, rec in self.channels.values():
            self.f.write(rec)
        counts = b"".join(struct.pack("<HQ", cid, n)
                          for cid, n in sorted(self.counts.items()))
        t0, t1 = (min(self.times), max(self.times)) if self.times else (0, 0)
        self.f.write(_record(OP_STATISTICS, struct.pack(
            "<QHIIII", sum(self.counts.values()), len(self.schemas),
            len(self.channels), 0, 0, len(self.chunk_indexes))
            + struct.pack("<QQ", t0, t1)
            + struct.pack("<I", len(counts)) + counts))
        for rec in self.chunk_indexes:
            self.f.write(rec)
        self.f.write(_record(OP_FOOTER, struct.pack("<QQI", summary, 0, 0)))
        self.f.write(MAGIC)
        self.size = self.f.tell()
        self.f.close()
        return self.size


def time_of(ns: int) -> tuple[int, int]:
    """(sec, nanosec) of a time in integer nanoseconds."""
    return ns // 1_000_000_000, ns % 1_000_000_000


def seconds(sec: int, nanosec: int) -> float:
    """A stamp in float64 seconds, as ROS's ``Time`` gives it."""
    return sec + nanosec * 1e-9


def stamp_of(t: float) -> tuple[int, int]:
    """The (sec, nanosec) whose ``seconds`` is exactly ``t``, a float64
    time (near 1.7e9 s, float64 steps by 238 ns, so one exists)."""
    sec = int(np.floor(t))
    ns = int(round((t - sec) * 1e9))
    for d in (0, -1, 1, -2, 2):
        if 0 <= ns + d < 1_000_000_000 and seconds(sec, ns + d) == t:
            return sec, ns + d
    raise ValueError(f"no nanosecond stamp gives {t!r} exactly")
