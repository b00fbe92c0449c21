"""ROS 2 message types + CDR codecs (ROS-free reimplementation).

Covers exactly the message surface the reference consumes/produces
(sensor_msgs/PointCloud2, sensor_msgs/LaserScan, tf2_msgs/TFMessage,
nav_msgs/Odometry; see ros/src/kinematic_icp_ros/): plain dataclasses plus
encode/decode against the CDR wire format, so mcap bags can be read and
written without any ROS installation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .cdr import CdrReader, CdrWriter


@dataclasses.dataclass
class Time:
    sec: int = 0
    nanosec: int = 0

    def to_sec(self) -> float:
        return self.sec + self.nanosec * 1e-9

    @staticmethod
    def from_sec(t: float) -> "Time":
        sec = int(t)
        return Time(sec, int(round((t - sec) * 1e9)))

    @staticmethod
    def read(r: CdrReader) -> "Time":
        return Time(r.int32(), r.uint32())

    def write(self, w: CdrWriter):
        w.int32(self.sec)
        w.uint32(self.nanosec)


@dataclasses.dataclass
class Header:
    stamp: Time = dataclasses.field(default_factory=Time)
    frame_id: str = ""

    @staticmethod
    def read(r: CdrReader) -> "Header":
        return Header(Time.read(r), r.string())

    def write(self, w: CdrWriter):
        self.stamp.write(w)
        w.string(self.frame_id)


# --------------------------------------------------------------------
# sensor_msgs/PointField + PointCloud2
# --------------------------------------------------------------------

class PointFieldType:
    INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)


_FIELD_DTYPE = {
    PointFieldType.INT8: np.int8, PointFieldType.UINT8: np.uint8,
    PointFieldType.INT16: np.int16, PointFieldType.UINT16: np.uint16,
    PointFieldType.INT32: np.int32, PointFieldType.UINT32: np.uint32,
    PointFieldType.FLOAT32: np.float32, PointFieldType.FLOAT64: np.float64,
}


@dataclasses.dataclass
class PointField:
    name: str = ""
    offset: int = 0
    datatype: int = PointFieldType.FLOAT32
    count: int = 1

    @staticmethod
    def read(r: CdrReader) -> "PointField":
        return PointField(r.string(), r.uint32(), r.uint8(), r.uint32())

    def write(self, w: CdrWriter):
        w.string(self.name)
        w.uint32(self.offset)
        w.uint8(self.datatype)
        w.uint32(self.count)


@dataclasses.dataclass
class PointCloud2:
    header: Header = dataclasses.field(default_factory=Header)
    height: int = 1
    width: int = 0
    fields: list = dataclasses.field(default_factory=list)
    is_bigendian: bool = False
    point_step: int = 0
    row_step: int = 0
    data: bytes = b""
    is_dense: bool = True

    @staticmethod
    def decode(payload: bytes) -> "PointCloud2":
        r = CdrReader(payload)
        msg = PointCloud2()
        msg.header = Header.read(r)
        msg.height = r.uint32()
        msg.width = r.uint32()
        nfields = r.uint32()
        msg.fields = [PointField.read(r) for _ in range(nfields)]
        msg.is_bigendian = r.boolean()
        msg.point_step = r.uint32()
        msg.row_step = r.uint32()
        msg.data = r.bytes_seq()
        msg.is_dense = r.boolean()
        return msg

    def encode(self) -> bytes:
        w = CdrWriter()
        self.header.write(w)
        w.uint32(self.height)
        w.uint32(self.width)
        w.uint32(len(self.fields))
        for f in self.fields:
            f.write(w)
        w.boolean(self.is_bigendian)
        w.uint32(self.point_step)
        w.uint32(self.row_step)
        w.bytes_seq(self.data)
        w.boolean(self.is_dense)
        return w.getvalue()

    # -- array interface (PointCloud2ToEigen / EigenToPointCloud2 parity,
    #    reference ros/src/kinematic_icp_ros/utils/RosUtils.cpp:30-63) ----

    def field(self, name: str) -> Optional[PointField]:
        out = None
        for f in self.fields:
            if f.name == name:
                out = f
        return out

    def field_array(self, name: str) -> Optional[np.ndarray]:
        """Extract one field as a (N,) numpy array (strided view copy)."""
        f = self.field(name)
        if f is None:
            return None
        n = self.height * self.width
        dt = _FIELD_DTYPE[f.datatype]
        raw = np.frombuffer(self.data, dtype=np.uint8)
        itemsize = np.dtype(dt).itemsize
        idx = (np.arange(n)[:, None] * self.point_step + f.offset
               + np.arange(itemsize)[None, :])
        return raw[idx].copy().view(dt).reshape(n)

    def xyz(self) -> np.ndarray:
        """(N, 3) float32 positions — PointCloud2ToEigen equivalent.

        Uses the native extraction loop (``native/kicp_io.cpp``) where it
        builds; numpy strided extraction otherwise.
        """
        fx, fy, fz = self.field("x"), self.field("y"), self.field("z")
        if (fx and fy and fz and not self.is_bigendian
                and fx.datatype == fy.datatype == fz.datatype):
            from . import native
            out = native.extract_pointcloud(
                self.data, self.height * self.width, self.point_step,
                fx.offset, fy.offset, fz.offset, fx.datatype)
            if out is not None:
                return out[0]
        return np.stack([self.field_array("x"), self.field_array("y"),
                         self.field_array("z")], axis=-1).astype(np.float32)

    @staticmethod
    def from_xyz(points, stamp: float = 0.0, frame_id: str = "lidar",
                 timestamps=None, timestamp_field: str = "t",
                 timestamp_type: int = PointFieldType.FLOAT32) -> "PointCloud2":
        """Build a cloud from (N, 3) [+ per-point timestamps]."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        n = len(points)
        fields = [PointField("x", 0, PointFieldType.FLOAT32, 1),
                  PointField("y", 4, PointFieldType.FLOAT32, 1),
                  PointField("z", 8, PointFieldType.FLOAT32, 1)]
        step = 12
        if timestamps is not None:
            dt = _FIELD_DTYPE[timestamp_type]
            fields.append(PointField(timestamp_field, step, timestamp_type, 1))
            step += np.dtype(dt).itemsize
        buf = np.zeros((n, step), np.uint8)
        buf[:, 0:12] = points.view(np.uint8).reshape(n, 12)
        if timestamps is not None:
            ts = np.asarray(timestamps, dtype=_FIELD_DTYPE[timestamp_type])
            w = ts.dtype.itemsize
            buf[:, 12:12 + w] = ts.view(np.uint8).reshape(n, w)
        return PointCloud2(
            header=Header(Time.from_sec(stamp), frame_id),
            height=1, width=n, fields=fields, is_bigendian=False,
            point_step=step, row_step=step * n, data=buf.tobytes(),
            is_dense=True)


# --------------------------------------------------------------------
# sensor_msgs/LaserScan
# --------------------------------------------------------------------

@dataclasses.dataclass
class LaserScan:
    header: Header = dataclasses.field(default_factory=Header)
    angle_min: float = 0.0
    angle_max: float = 0.0
    angle_increment: float = 0.0
    time_increment: float = 0.0
    scan_time: float = 0.0
    range_min: float = 0.0
    range_max: float = 0.0
    ranges: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    intensities: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    @staticmethod
    def decode(payload: bytes) -> "LaserScan":
        r = CdrReader(payload)
        msg = LaserScan()
        msg.header = Header.read(r)
        msg.angle_min = r.float32()
        msg.angle_max = r.float32()
        msg.angle_increment = r.float32()
        msg.time_increment = r.float32()
        msg.scan_time = r.float32()
        msg.range_min = r.float32()
        msg.range_max = r.float32()
        msg.ranges = r.float32_seq()
        msg.intensities = r.float32_seq()
        return msg

    def encode(self) -> bytes:
        w = CdrWriter()
        self.header.write(w)
        for v in (self.angle_min, self.angle_max, self.angle_increment,
                  self.time_increment, self.scan_time, self.range_min,
                  self.range_max):
            w.float32(v)
        w.float32_seq(self.ranges)
        w.float32_seq(self.intensities)
        return w.getvalue()


# --------------------------------------------------------------------
# geometry_msgs/TransformStamped + tf2_msgs/TFMessage
# --------------------------------------------------------------------

@dataclasses.dataclass
class TransformStamped:
    header: Header = dataclasses.field(default_factory=Header)
    child_frame_id: str = ""
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0, 0, 1]))  # x y z w

    @staticmethod
    def read(r: CdrReader) -> "TransformStamped":
        msg = TransformStamped()
        msg.header = Header.read(r)
        msg.child_frame_id = r.string()
        msg.translation = np.array([r.float64(), r.float64(), r.float64()])
        msg.rotation = np.array([r.float64(), r.float64(), r.float64(),
                                 r.float64()])
        return msg

    def write(self, w: CdrWriter):
        self.header.write(w)
        w.string(self.child_frame_id)
        for v in self.translation:
            w.float64(float(v))
        for v in self.rotation:
            w.float64(float(v))

    def matrix(self) -> np.ndarray:
        from scipy.spatial.transform import Rotation
        T = np.eye(4)
        T[:3, :3] = Rotation.from_quat(self.rotation).as_matrix()
        T[:3, 3] = self.translation
        return T

    @staticmethod
    def from_matrix(T, stamp: float, frame_id: str,
                    child_frame_id: str) -> "TransformStamped":
        from scipy.spatial.transform import Rotation
        T = np.asarray(T, np.float64)
        return TransformStamped(
            header=Header(Time.from_sec(stamp), frame_id),
            child_frame_id=child_frame_id,
            translation=T[:3, 3].copy(),
            rotation=Rotation.from_matrix(T[:3, :3]).as_quat())


@dataclasses.dataclass
class TFMessage:
    transforms: list = dataclasses.field(default_factory=list)

    @staticmethod
    def decode(payload: bytes) -> "TFMessage":
        r = CdrReader(payload)
        n = r.uint32()
        return TFMessage([TransformStamped.read(r) for _ in range(n)])

    def encode(self) -> bytes:
        w = CdrWriter()
        w.uint32(len(self.transforms))
        for t in self.transforms:
            t.write(w)
        return w.getvalue()


# --------------------------------------------------------------------
# nav_msgs/Odometry (published by the server; also parseable for ingestion)
# --------------------------------------------------------------------

@dataclasses.dataclass
class Odometry:
    header: Header = dataclasses.field(default_factory=Header)
    child_frame_id: str = ""
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0, 0, 1]))
    pose_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(36))
    twist_linear: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    twist_angular: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    twist_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(36))

    @staticmethod
    def decode(payload: bytes) -> "Odometry":
        r = CdrReader(payload)
        msg = Odometry()
        msg.header = Header.read(r)
        msg.child_frame_id = r.string()
        msg.position = np.array([r.float64() for _ in range(3)])
        msg.orientation = np.array([r.float64() for _ in range(4)])
        msg.pose_covariance = r.float64_array(36).copy()
        msg.twist_linear = np.array([r.float64() for _ in range(3)])
        msg.twist_angular = np.array([r.float64() for _ in range(3)])
        msg.twist_covariance = r.float64_array(36).copy()
        return msg

    def encode(self) -> bytes:
        w = CdrWriter()
        self.header.write(w)
        w.string(self.child_frame_id)
        for v in self.position:
            w.float64(float(v))
        for v in self.orientation:
            w.float64(float(v))
        w.float64_array(self.pose_covariance)
        for v in self.twist_linear:
            w.float64(float(v))
        for v in self.twist_angular:
            w.float64(float(v))
        w.float64_array(self.twist_covariance)
        return w.getvalue()


#: schema names as stored in rosbag2 mcap files
SCHEMA_DECODERS = {
    "sensor_msgs/msg/PointCloud2": PointCloud2.decode,
    "sensor_msgs/msg/LaserScan": LaserScan.decode,
    "tf2_msgs/msg/TFMessage": TFMessage.decode,
    "nav_msgs/msg/Odometry": Odometry.decode,
}
