"""Host-side message I/O: ROS 2 message types and their CDR codec, per-point
timestamps, the tf buffer, the LaserScan projection, TUM trajectories, and
the bag layer (mcap with its lz4 codec, rosbag2 sqlite, the tf look-ahead
reader).  Numpy, with the native extraction loops of ``native/kicp_io.cpp``
where they build; the same wire and file formats as the JAX package's."""
