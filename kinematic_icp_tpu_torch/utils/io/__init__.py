"""Host-side message I/O: ROS 2 message types and their CDR codec, per-point
timestamps, the tf buffer, the LaserScan projection and TUM trajectories.
Plain numpy; the same wire and file formats as the JAX package's."""
