"""Minimal MCAP container reader/writer (pure Python, no mcap package).

Replaces the rosbag2 storage layer used by the reference's offline path
(ros/src/kinematic_icp_ros/utils/RosbagUtils.cpp): reads the subset of MCAP
that rosbag2 writes — Header/Schema/Channel/Message records, optionally
wrapped in zstd-, lz4- or uncompressed Chunks — and writes valid minimal
files for round-trip tests and dataset conversion.  lz4 uses the bundled
pure-Python codec (utils/io/lz4f.py) when no lz4 module is available.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Iterator, Optional

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_STATISTICS = 0x0B
OP_DATA_END = 0x0F

#: the Header record's library field: the JAX package's writer's, so the
#: two packages write the same bytes
LIBRARY = "kinematic_icp_tpu"

#: footer record (op + len + 20-byte body) plus trailing magic
_FOOTER_TAIL = 9 + 20 + 8


@dataclasses.dataclass
class Schema:
    id: int
    name: str
    encoding: str
    data: bytes


@dataclasses.dataclass
class Channel:
    id: int
    schema_id: int
    topic: str
    message_encoding: str


@dataclasses.dataclass
class Message:
    channel: Channel
    schema: Optional[Schema]
    log_time: int       # nanoseconds
    publish_time: int
    sequence: int
    data: bytes

    @property
    def log_time_sec(self) -> float:
        return self.log_time * 1e-9


def _read_prefixed_string(buf, pos):
    n = struct.unpack_from("<I", buf, pos)[0]
    return buf[pos + 4:pos + 4 + n].decode("utf-8"), pos + 4 + n


class McapReader:
    """Streaming reader yielding Messages in file order."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "read"):
            self._f = path_or_file
            self._owns = False
        else:
            self._f = open(path_or_file, "rb")
            self._owns = True
        magic = self._f.read(8)
        if magic != MAGIC:
            raise ValueError(f"not an MCAP file (magic {magic!r})")
        self.schemas: dict[int, Schema] = {}
        self.channels: dict[int, Channel] = {}

    def close(self):
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _parse_schema(self, rec: bytes):
        sid, = struct.unpack_from("<H", rec, 0)
        name, pos = _read_prefixed_string(rec, 2)
        enc, pos = _read_prefixed_string(rec, pos)
        dlen, = struct.unpack_from("<I", rec, pos)
        data = rec[pos + 4:pos + 4 + dlen]
        self.schemas[sid] = Schema(sid, name, enc, data)

    def _parse_channel(self, rec: bytes):
        cid, sid = struct.unpack_from("<HH", rec, 0)
        topic, pos = _read_prefixed_string(rec, 4)
        enc, pos = _read_prefixed_string(rec, pos)
        self.channels[cid] = Channel(cid, sid, topic, enc)

    def _parse_message(self, rec: bytes) -> Message:
        cid, seq, log_t, pub_t = struct.unpack_from("<HIQQ", rec, 0)
        ch = self.channels.get(cid)
        if ch is None:
            raise ValueError(f"message on unknown channel {cid}")
        schema = self.schemas.get(ch.schema_id)
        return Message(ch, schema, log_t, pub_t, seq, rec[22:])

    def _iter_records(self, buf: bytes) -> Iterator[tuple[int, bytes]]:
        pos = 0
        while pos + 9 <= len(buf):
            op = buf[pos]
            length, = struct.unpack_from("<Q", buf, pos + 1)
            pos += 9
            yield op, buf[pos:pos + length]
            pos += length

    def messages(self, topics=None) -> Iterator[Message]:
        """Yield messages (optionally filtered by topic set), file order."""
        topics = set(topics) if topics else None
        while True:
            head = self._f.read(9)
            if len(head) < 9:
                return
            op = head[0]
            length, = struct.unpack("<Q", head[1:])
            if op == OP_FOOTER or op == 0:
                return
            rec = self._f.read(length)
            if len(rec) < length:
                # Truncated file (crashed recorder / partial copy): yield
                # what was intact and stop, like rosbag2's recovery read.
                import warnings
                warnings.warn(
                    f"truncated MCAP record (op {op}: got {len(rec)} of "
                    f"{length} bytes); stopping at the last intact message")
                return
            if op == OP_SCHEMA:
                self._parse_schema(rec)
            elif op == OP_CHANNEL:
                self._parse_channel(rec)
            elif op == OP_MESSAGE:
                msg = self._parse_message(rec)
                if topics is None or msg.channel.topic in topics:
                    yield msg
            elif op == OP_CHUNK:
                yield from self._iter_chunk(rec, topics)
            # other records (indexes, stats, attachments) are skipped

    def _iter_chunk(self, rec: bytes, topics) -> Iterator[Message]:
        # Chunk: start_time(8) end_time(8) uncompressed_size(8)
        #        uncompressed_crc(4) compression(string) records_len(8) records
        pos = 28
        compression, pos = _read_prefixed_string(rec, pos)
        rlen, = struct.unpack_from("<Q", rec, pos)
        pos += 8
        payload = rec[pos:pos + rlen]
        if compression in ("", "none"):
            records = payload
        elif compression == "zstd":
            import zstandard
            records = zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=1 << 31)
        elif compression == "lz4":
            try:
                import lz4.frame
                records = lz4.frame.decompress(payload)
            except ImportError:
                from .lz4f import decompress_frame
                records = decompress_frame(payload)
        else:
            raise ValueError(f"unknown chunk compression {compression!r}")
        for op, body in self._iter_records(records):
            if op == OP_SCHEMA:
                self._parse_schema(body)
            elif op == OP_CHANNEL:
                self._parse_channel(body)
            elif op == OP_MESSAGE:
                msg = self._parse_message(body)
                if topics is None or msg.channel.topic in topics:
                    yield msg

    # ------------------------------------------------------------------
    def count_messages(self, topic: str) -> int:
        """Count messages on a topic — from the summary section's
        Statistics record when present (the reference counts via rosbag2
        metadata, RosbagUtils.cpp:82-93), otherwise by a full rescan."""
        n = self._count_from_summary(topic)
        if n is not None:
            return n
        pos = self._f.tell()
        self._f.seek(len(MAGIC))
        n = sum(1 for _ in self.messages([topic]))
        self._f.seek(pos)
        return n

    def _count_from_summary(self, topic: str) -> int | None:
        """Per-channel count from the summary section, or None if absent."""
        if not self._f.seekable():
            return None
        keep = self._f.tell()
        try:
            self._f.seek(-_FOOTER_TAIL, io.SEEK_END)
            head = self._f.read(9)
            if len(head) < 9 or head[0] != OP_FOOTER:
                return None
            summary_start, = struct.unpack("<Q", self._f.read(8))
            if summary_start == 0:
                return None
            self._f.seek(summary_start)
            channels: dict[int, str] = {}
            counts: dict[int, int] | None = None
            while True:
                head = self._f.read(9)
                if len(head) < 9 or head[0] in (OP_FOOTER, 0):
                    break
                op = head[0]
                length, = struct.unpack("<Q", head[1:])
                rec = self._f.read(length)
                if op == OP_CHANNEL:
                    cid, = struct.unpack_from("<H", rec, 0)
                    t, _ = _read_prefixed_string(rec, 4)
                    channels[cid] = t
                elif op == OP_STATISTICS:
                    # message_count(8) schema_count(2) channel_count(4)
                    # attachment_count(4) metadata_count(4) chunk_count(4)
                    # start(8) end(8) channel_message_counts(map)
                    map_len, = struct.unpack_from("<I", rec, 42)
                    counts = {}
                    pos, end = 46, 46 + map_len
                    while pos + 10 <= end:
                        cid, cnt = struct.unpack_from("<HQ", rec, pos)
                        counts[cid] = cnt
                        pos += 10
            # The spec allows a writer to omit channel_message_counts (or
            # individual channels) from Statistics; an empty map — or a
            # topic none of whose channel ids appear in the map — means
            # "no summary info", not "zero messages": fall back to rescan.
            if not counts or not channels:
                return None
            topic_cids = {cid for cid, t in channels.items() if t == topic}
            if topic_cids and not (topic_cids & counts.keys()):
                return None
            return sum(cnt for cid, cnt in counts.items()
                       if cid in topic_cids)
        except (OSError, struct.error):
            return None
        finally:
            self._f.seek(keep)


class McapWriter:
    """Minimal writer: header + schemas/channels + (chunked) messages."""

    def __init__(self, path_or_file, profile: str = "ros2",
                 compression: str = ""):
        if compression not in ("", "zstd", "lz4"):
            raise ValueError(f"chunk compression {compression!r}")
        if hasattr(path_or_file, "write"):
            self._f = path_or_file
            self._owns = False
        else:
            self._f = open(path_or_file, "wb")
            self._owns = True
        self.compression = compression
        self._schemas: dict[str, int] = {}
        self._channels: dict[str, int] = {}
        self._schema_recs: list[bytes] = []
        self._channel_recs: list[bytes] = []
        self._messages: list[tuple[int, bytes]] = []
        self._channel_counts: dict[int, int] = {}
        self._chunk_count = 0
        self._time_range: list[int] = []
        self._pending_bytes = 0
        #: flush a compressed chunk when buffered records reach this size
        #: (rosbag2's default chunk target) — bounds writer memory and keeps
        #: chunks seekable instead of one whole-bag chunk
        self.chunk_size = 1 << 20
        self._f.write(MAGIC)
        self._record(OP_HEADER, self._string(profile) + self._string(
            LIBRARY))

    @staticmethod
    def _string(s: str) -> bytes:
        raw = s.encode("utf-8")
        return struct.pack("<I", len(raw)) + raw

    def _record_bytes(self, op: int, body: bytes) -> bytes:
        return struct.pack("<BQ", op, len(body)) + body

    def _record(self, op: int, body: bytes):
        self._f.write(self._record_bytes(op, body))

    def add_schema(self, name: str, encoding: str = "ros2msg",
                   data: bytes = b"") -> int:
        if name in self._schemas:
            return self._schemas[name]
        sid = len(self._schemas) + 1
        self._schemas[name] = sid
        body = (struct.pack("<H", sid) + self._string(name)
                + self._string(encoding)
                + struct.pack("<I", len(data)) + data)
        self._schema_recs.append(self._record_bytes(OP_SCHEMA, body))
        self._f.write(self._schema_recs[-1])
        return sid

    def add_channel(self, topic: str, schema_name: str,
                    message_encoding: str = "cdr") -> int:
        if topic in self._channels:
            return self._channels[topic]
        sid = self.add_schema(schema_name)
        cid = len(self._channels)
        self._channels[topic] = cid
        body = (struct.pack("<HH", cid, sid) + self._string(topic)
                + self._string(message_encoding) + struct.pack("<I", 0))
        self._channel_recs.append(self._record_bytes(OP_CHANNEL, body))
        self._f.write(self._channel_recs[-1])
        return cid

    def write_message(self, topic: str, schema_name: str, data: bytes,
                      log_time_ns: int, publish_time_ns: int | None = None,
                      sequence: int = 0):
        cid = self.add_channel(topic, schema_name)
        if publish_time_ns is None:
            publish_time_ns = log_time_ns
        body = struct.pack("<HIQQ", cid, sequence, log_time_ns,
                           publish_time_ns) + data
        self._channel_counts[cid] = self._channel_counts.get(cid, 0) + 1
        if not self._time_range:
            self._time_range = [log_time_ns, log_time_ns]
        else:
            self._time_range[0] = min(self._time_range[0], log_time_ns)
            self._time_range[1] = max(self._time_range[1], log_time_ns)
        if self.compression:
            rec = self._record_bytes(OP_MESSAGE, body)
            self._messages.append((log_time_ns, rec))
            self._pending_bytes += len(rec)
            if self._pending_bytes >= self.chunk_size:
                self._flush_chunk()
        else:
            self._record(OP_MESSAGE, body)

    def _flush_chunk(self):
        if not self._messages:
            return
        records = b"".join(rec for _, rec in self._messages)
        if self.compression == "zstd":
            import zstandard
            payload = zstandard.ZstdCompressor().compress(records)
        else:  # lz4
            from .lz4f import compress_frame
            payload = compress_frame(records)
        times = [t for t, _ in self._messages]
        body = (struct.pack("<QQQI", min(times), max(times), len(records), 0)
                + self._string(self.compression)
                + struct.pack("<Q", len(payload)) + payload)
        self._record(OP_CHUNK, body)
        self._chunk_count += 1
        self._messages.clear()
        self._pending_bytes = 0

    def close(self):
        self._flush_chunk()
        self._record(OP_DATA_END, struct.pack("<I", 0))
        # Summary section: repeated schema/channel records + Statistics, so
        # readers (ours included) count messages without a full scan.
        summary_start = self._f.tell()
        for rec in self._schema_recs + self._channel_recs:
            self._f.write(rec)
        cmap = b"".join(struct.pack("<HQ", cid, cnt)
                        for cid, cnt in sorted(self._channel_counts.items()))
        t0, t1 = (self._time_range or [0, 0])
        self._record(OP_STATISTICS, struct.pack(
            "<QHIIII", sum(self._channel_counts.values()),
            len(self._schemas), len(self._channels), 0, 0,
            self._chunk_count) + struct.pack("<QQ", t0, t1)
            + struct.pack("<I", len(cmap)) + cmap)
        # footer: summary_start(8) summary_offset_start(8) summary_crc(4)
        self._record(OP_FOOTER, struct.pack("<QQI", summary_start, 0, 0))
        self._f.write(MAGIC)
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
