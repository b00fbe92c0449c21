"""Bag ingestion: look-ahead buffered reading of bag files + multiplexing.

Reimplements ``BufferableBag`` / ``BagMultiplexer``
(ros/src/kinematic_icp_ros/utils/RosbagUtils.cpp): while draining the bag,
``/tf`` and ``/tf_static`` messages are eagerly replayed into the transform
buffer at least ``buffer_size`` seconds AHEAD of the lidar message being
delivered (cpp:102-124, default window 1 s), so odometry lookups between the
current and next scan stamps always have surrounding tf samples.  Multiple
bags chain sequentially (cpp:134-148).
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

from .mcap import Message
from .messages import SCHEMA_DECODERS, TFMessage
from .sqlite_bag import open_bag
from .tf import TransformBuffer


class BufferableBag:
    """One bag file (mcap or rosbag2 sqlite .db3) with tf bridging and a
    time look-ahead buffer."""

    def __init__(self, path, tf_buffer: TransformBuffer, topic: str,
                 buffer_size: float = 1.0):
        self.reader = open_bag(path)
        self.tf_buffer = tf_buffer
        self.topic = topic
        self.buffer_size = buffer_size
        self._stream = self.reader.messages()
        self._buffer: deque[Message] = deque()
        self._exhausted = False

    def _process(self, msg: Message):
        if msg.channel.topic in ("/tf", "/tf_static"):
            tf_msg = TFMessage.decode(msg.data)
            static = msg.channel.topic == "/tf_static"
            for t in tf_msg.transforms:
                self.tf_buffer.add_transform_stamped(t, is_static=static)
        elif msg.channel.topic == self.topic:
            self._buffer.append(msg)

    def _fill(self):
        """Read ahead until the window invariant holds (cpp:103-108)."""
        while not self._exhausted:
            if (len(self._buffer) >= 2
                    and (self._buffer[-1].log_time_sec
                         - self._buffer[0].log_time_sec) > self.buffer_size):
                return
            try:
                self._process(next(self._stream))
            except StopIteration:
                self._exhausted = True

    def finished(self) -> bool:
        self._fill()
        return not self._buffer

    def pop_next_message(self) -> Message:
        self._fill()
        return self._buffer.popleft()

    def message_count(self) -> int:
        return self.reader.count_messages(self.topic)

    def __iter__(self) -> Iterator[Message]:
        while not self.finished():
            yield self.pop_next_message()


class BagMultiplexer:
    """Sequential chain of bags (RosbagUtils.cpp:134-148)."""

    def __init__(self):
        self.bags: list[BufferableBag] = []
        self._idx = 0

    def add_bag(self, bag: BufferableBag):
        self.bags.append(bag)

    def message_count(self) -> int:
        return sum(b.message_count() for b in self.bags)

    def finished(self) -> bool:
        while self._idx < len(self.bags) and self.bags[self._idx].finished():
            self._idx += 1
        return self._idx >= len(self.bags)

    def get_next_message(self) -> Message:
        if self.finished():
            raise StopIteration
        return self.bags[self._idx].pop_next_message()

    def __iter__(self) -> Iterator[Message]:
        while not self.finished():
            yield self.get_next_message()


def decode_message(msg: Message):
    """Decode a Message via its schema name (rosbag2 deserialization parity)."""
    if msg.schema is None:
        raise ValueError(f"no schema for topic {msg.channel.topic}")
    dec = SCHEMA_DECODERS.get(msg.schema.name)
    if dec is None:
        raise ValueError(f"unsupported schema {msg.schema.name}")
    return dec(msg.data)
