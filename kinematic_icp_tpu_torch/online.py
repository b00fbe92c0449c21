"""Online odometry node: live message-stream processing.

The reference OnlineNode equivalent
(ros/src/kinematic_icp_ros/nodes/online_node.cpp): consumes a stream of
decoded messages (3D PointCloud2, or 2D LaserScan projected on the fly,
cpp:45-58, plus tf updates) and runs the odometry server per scan,
optionally emitting nav_msgs/Odometry + tf messages per frame, the publish
surface of the reference (minus DDS).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from .config import Config, ServerConfig
from .server import LidarOdometryServer
from .utils.io.laserscan import project_laser
from .utils.io.messages import LaserScan, PointCloud2, TFMessage
from .utils.io.tf import TransformBuffer


class OnlineOdometryNode:
    """Composable online node over an arbitrary transport.

    Feed it messages via ``handle_*`` callbacks (or drive ``run`` with an
    iterator of (topic-kind, message) tuples); register an
    ``on_odometry(odom_msg, tf_msg, result)`` callback for the outputs.
    ``device`` is the server's (``None`` = CUDA; raises without a card).
    """

    def __init__(self, config: Config | None = None,
                 server_config: ServerConfig | None = None,
                 use_2d_lidar: bool = False,
                 on_odometry: Optional[Callable] = None, device=None):
        self.config = config or Config()
        self.server_config = server_config or ServerConfig()
        self.use_2d_lidar = use_2d_lidar
        self.tf_buffer = TransformBuffer()
        self.server = LidarOdometryServer(self.config, self.server_config,
                                          device=device)
        self.on_odometry = on_odometry

    # -- input callbacks ------------------------------------------------
    def handle_tf(self, msg: TFMessage, is_static: bool = False):
        for t in msg.transforms:
            self.tf_buffer.add_transform_stamped(t, is_static=is_static)

    def handle_laserscan(self, msg: LaserScan):
        return self.handle_pointcloud(project_laser(msg))

    def handle_pointcloud(self, msg: PointCloud2):
        result = self.server.register_message(msg, self.tf_buffer)
        if result is not None and self.on_odometry is not None:
            stamp = self.server.last_stamp
            odom = self.server.make_odometry_message(result, stamp)
            tf_msg = self.server.make_tf_message(result, stamp)
            self.on_odometry(odom, tf_msg, result)
        return result

    # -- message loop ---------------------------------------------------
    def run(self, stream: Iterable):
        """Process (kind, message) tuples: kind in
        {'tf', 'tf_static', 'pointcloud', 'laserscan'}."""
        for kind, msg in stream:
            if kind == "tf":
                self.handle_tf(msg)
            elif kind == "tf_static":
                self.handle_tf(msg, is_static=True)
            elif kind == "laserscan":
                if self.use_2d_lidar:
                    self.handle_laserscan(msg)
            elif kind == "pointcloud":
                if not self.use_2d_lidar:
                    self.handle_pointcloud(msg)
