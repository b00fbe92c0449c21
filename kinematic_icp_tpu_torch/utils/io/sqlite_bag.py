"""rosbag2 sqlite3 (.db3) storage reader — the reference's other bag format.

rosbag2's sqlite storage plugin (read by the reference via rosbag2_cpp,
ros/src/kinematic_icp_ros/utils/RosbagUtils.cpp:82-93) uses two tables:

    topics(id, name, type, serialization_format, offered_qos_profiles)
    messages(id, topic_id, timestamp, data)

``type`` is the ROS type name (e.g. ``sensor_msgs/msg/PointCloud2``) and
``data`` the CDR-serialized payload — exactly what our decoders consume.
This reader presents the same interface as ``McapReader`` (``messages()``
yielding ``Message`` objects in timestamp order, ``count_messages``), so
``BufferableBag``/``BagMultiplexer`` work over either storage unchanged.

Also provides a minimal writer for fixtures and dataset conversion.
"""

from __future__ import annotations

import sqlite3
from typing import Iterator

from .mcap import Channel, Message, Schema


class SqliteBagReader:
    """Reader over a rosbag2 sqlite3 file, Message-compatible with mcap."""

    def __init__(self, path):
        self._conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.schemas: dict[int, Schema] = {}
        self.channels: dict[int, Channel] = {}
        for tid, name, typ, fmt in self._conn.execute(
                "SELECT id, name, type, serialization_format FROM topics"):
            self.schemas[tid] = Schema(tid, typ, "ros2msg", b"")
            self.channels[tid] = Channel(tid, tid, name, fmt or "cdr")

    def close(self):
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def messages(self, topics=None) -> Iterator[Message]:
        """Yield messages in timestamp order (rosbag2 replay order)."""
        q = ("SELECT topic_id, timestamp, data FROM messages "
             "ORDER BY timestamp, id")
        args = ()
        if topics is not None:
            # filter in SQL so non-matching rows' BLOBs never leave sqlite
            wanted = [tid for tid, ch in self.channels.items()
                      if ch.topic in set(topics)]
            q = (f"SELECT topic_id, timestamp, data FROM messages WHERE "
                 f"topic_id IN ({','.join('?' * len(wanted))}) "
                 f"ORDER BY timestamp, id")
            args = tuple(wanted)
        for tid, stamp, data in self._conn.execute(q, args):
            ch = self.channels.get(tid)
            if ch is None:
                continue
            yield Message(ch, self.schemas.get(tid), stamp, stamp, 0,
                          bytes(data))

    def count_messages(self, topic: str) -> int:
        """Metadata-style count (one indexed query, unlike the mcap rescan;
        matches the reference counting via metadata, RosbagUtils.cpp:82-93)."""
        row = self._conn.execute(
            "SELECT COUNT(*) FROM messages m JOIN topics t "
            "ON m.topic_id = t.id WHERE t.name = ?", (topic,)).fetchone()
        return int(row[0])


class SqliteBagWriter:
    """Minimal rosbag2-schema sqlite writer (fixtures / conversion)."""

    def __init__(self, path):
        self._conn = sqlite3.connect(path)
        c = self._conn
        c.execute("CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT "
                  "NOT NULL, type TEXT NOT NULL, serialization_format TEXT "
                  "NOT NULL, offered_qos_profiles TEXT NOT NULL)")
        c.execute("CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id "
                  "INTEGER NOT NULL, timestamp INTEGER NOT NULL, data BLOB "
                  "NOT NULL)")
        c.execute("CREATE INDEX timestamp_idx ON messages (timestamp ASC)")
        self._topics: dict[str, int] = {}

    def add_topic(self, name: str, type_name: str) -> int:
        if name in self._topics:
            return self._topics[name]
        tid = len(self._topics) + 1
        self._conn.execute(
            "INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')",
            (tid, name, type_name))
        self._topics[name] = tid
        return tid

    def write_message(self, topic: str, type_name: str, data: bytes,
                      log_time_ns: int):
        tid = self.add_topic(topic, type_name)
        self._conn.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)",
            (tid, log_time_ns, sqlite3.Binary(data)))

    def close(self):
        self._conn.commit()
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_bag(path):
    """Open a bag by extension: .mcap or rosbag2 sqlite (.db3/.db)."""
    p = str(path)
    if p.endswith((".db3", ".db", ".sqlite3")):
        return SqliteBagReader(p)
    from .mcap import McapReader
    return McapReader(p)
