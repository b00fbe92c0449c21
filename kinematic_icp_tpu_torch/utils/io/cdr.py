"""Minimal CDR (Common Data Representation) codec for ROS 2 messages.

Replaces rclcpp's serialization layer for the bag-ingestion path
(reference: ros/src/kinematic_icp_ros/nodes/offline_node.cpp:120-136
deserializes PointCloud2/LaserScan from rosbag2).  Implements the XCDR1
little-endian subset ROS 2 uses: a 4-byte encapsulation header followed by
primitives aligned to their size (relative to the post-header origin),
``string`` as uint32 length + bytes + NUL, sequences as uint32 count +
elements.

``CdrReader`` reads any bytes-like payload (``bytes``, or a ``memoryview``
of the bag's chunk) without copying it: byte and float sequences come back
as views of the payload, and only strings are copied out.
"""

from __future__ import annotations

import struct


class CdrReader:
    def __init__(self, data: bytes | memoryview):
        self.data = memoryview(data)
        if len(data) < 4:
            raise ValueError("CDR payload too short")
        # encapsulation: {representation_id (2B), options (2B)}
        rep = bytes(self.data[:2])
        if rep not in (b"\x00\x01", b"\x00\x00"):
            raise ValueError(f"unsupported CDR encapsulation {rep!r}")
        self.little = rep[1] == 1
        self.pos = 4

    def _align(self, size: int):
        # alignment is relative to the start of the serialized body
        off = (self.pos - 4) % size
        if off:
            self.pos += size - off

    def _read(self, fmt: str, size: int):
        self._align(size)
        end = "<" if self.little else ">"
        val = struct.unpack_from(end + fmt, self.data, self.pos)[0]
        self.pos += size
        return val

    def uint8(self):
        return self._read("B", 1)

    def int8(self):
        return self._read("b", 1)

    def boolean(self):
        return bool(self._read("B", 1))

    def uint16(self):
        return self._read("H", 2)

    def int32(self):
        return self._read("i", 4)

    def uint32(self):
        return self._read("I", 4)

    def int64(self):
        return self._read("q", 8)

    def uint64(self):
        return self._read("Q", 8)

    def float32(self):
        return self._read("f", 4)

    def float64(self):
        return self._read("d", 8)

    def string(self) -> str:
        n = self.uint32()
        s = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return s.rstrip(b"\x00").decode("utf-8", errors="replace")

    def bytes_seq(self) -> memoryview:
        """A view of the payload's bytes: no copy."""
        n = self.uint32()
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def float32_seq(self):
        import numpy as np
        n = self.uint32()
        self._align(4)
        arr = np.frombuffer(self.data, dtype="<f4" if self.little else ">f4",
                            count=n, offset=self.pos)
        self.pos += 4 * n
        return arr

    def float64_array(self, n: int):
        import numpy as np
        self._align(8)
        arr = np.frombuffer(self.data, dtype="<f8" if self.little else ">f8",
                            count=n, offset=self.pos)
        self.pos += 8 * n
        return arr


class CdrWriter:
    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")  # CDR_LE

    def _align(self, size: int):
        off = (len(self.buf) - 4) % size
        if off:
            self.buf += b"\x00" * (size - off)

    def _write(self, fmt: str, size: int, val):
        self._align(size)
        self.buf += struct.pack("<" + fmt, val)

    def uint8(self, v):
        self._write("B", 1, v)

    def boolean(self, v):
        self._write("B", 1, 1 if v else 0)

    def uint16(self, v):
        self._write("H", 2, v)

    def int32(self, v):
        self._write("i", 4, v)

    def uint32(self, v):
        self._write("I", 4, v)

    def uint64(self, v):
        self._write("Q", 8, v)

    def float32(self, v):
        self._write("f", 4, v)

    def float64(self, v):
        self._write("d", 8, v)

    def string(self, s: str):
        raw = s.encode("utf-8") + b"\x00"
        self.uint32(len(raw))
        self.buf += raw

    def bytes_seq(self, b: bytes):
        self.uint32(len(b))
        self.buf += b

    def float32_seq(self, arr):
        import numpy as np
        arr = np.asarray(arr, dtype="<f4")
        self.uint32(len(arr))
        self._align(4)
        self.buf += arr.tobytes()

    def float64_array(self, arr):
        import numpy as np
        arr = np.asarray(arr, dtype="<f8")
        self._align(8)
        self.buf += arr.tobytes()

    def getvalue(self) -> bytes:
        return bytes(self.buf)
