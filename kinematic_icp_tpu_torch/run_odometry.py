"""Offline odometry runner: mcap / rosbag2 sqlite bag(s) -> TUM trajectory.

The reference OfflineNode equivalent
(ros/src/kinematic_icp_ros/nodes/offline_node.cpp:99-149): drains one or
more bags through the look-ahead buffered reader, replays /tf into the
transform buffer, converts each scan (3D PointCloud2 or 2D LaserScan),
queries the wheel-odometry delta between scan stamps, registers it through
``server.LidarOdometryServer.register_message`` (one GN kernel launch a
registered frame on a CUDA card), and writes
``<bag>_kinematic_icp_poses_tum.txt``.

Usage:
  python -m kinematic_icp_tpu_torch.run_odometry BAG [BAG...]
      [--lidar-topic /lidar_points] [--use-2d-lidar]
      [--base-frame base_link] [--wheel-odom-frame odom]
      [--config params.yaml] [--output-dir DIR] [--max-frames N]
      [--device cuda|cpu]

The arguments are the JAX package's, plus ``--device`` (its counterpart of
``JAX_PLATFORMS``): ``cuda`` by default, which raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def build_arg_parser():
    p = argparse.ArgumentParser(
        description="Kinematic-ICP offline odometry on PyTorch/CUDA")
    p.add_argument("bags", nargs="+", help="mcap bag file(s), chained")
    p.add_argument("--lidar-topic", default="/lidar_points")
    p.add_argument("--use-2d-lidar", action="store_true",
                   help="treat the topic as sensor_msgs/LaserScan")
    p.add_argument("--base-frame", default="base_link")
    p.add_argument("--wheel-odom-frame", default="odom")
    p.add_argument("--config", default=None, help="parameter YAML")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--max-points", type=int, default=65536,
                   help="padded per-scan point capacity")
    p.add_argument("--no-progress", action="store_true")
    p.add_argument("--visualize", action="store_true",
                   help="also write <bag>_kinematic_icp_view.html — a "
                        "standalone interactive 3D view of the trajectory "
                        "and final local map (the RViz-profile equivalent; "
                        "mirrors the reference launch files' visualize arg)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the odometry state (cuda or cpu)")
    return p


def run(args, timings: dict | None = None) -> str:
    """Run the CLI over ``args``; returns the TUM file's path.

    ``timings``, when given, receives the wall seconds spent reading and
    decoding messages (``read_s``: bag read, tf replay, CDR decode, scan
    conversion), registering them (``register_s``) and writing the outputs
    (``write_s``), the scans written to the TUM file (``frames``) and those
    the server registered (``registered``: the others were stationary)."""
    from . import Config, ServerConfig, load_yaml_config
    from .server import LidarOdometryServer
    from .utils.io.bag import BagMultiplexer, BufferableBag, decode_message
    from .utils.io.laserscan import project_laser
    from .utils.io.messages import LaserScan, PointCloud2
    from .utils.io.tf import TransformBuffer
    from .utils.progress import ProgressBar

    if args.config:
        config, server_cfg = load_yaml_config(args.config)
    else:
        # the reference ships YAML that enables deskew (kinematic_icp_ros.yaml)
        config, server_cfg = Config(deskew=True), ServerConfig()
    config = config.replace(max_points=args.max_points)
    server_cfg = dataclasses.replace(server_cfg, base_frame=args.base_frame,
                                     wheel_odom_frame=args.wheel_odom_frame)
    # first, so that a missing card raises before any bag is opened
    server = LidarOdometryServer(config, server_cfg, device=args.device)

    tf_buffer = TransformBuffer()
    mux = BagMultiplexer()
    for bag in args.bags:
        mux.add_bag(BufferableBag(bag, tf_buffer, args.lidar_topic))
    total = mux.message_count()
    if args.max_frames:
        total = min(total, args.max_frames)

    progress = (None if args.no_progress
                else ProgressBar(total, desc="kinematic-icp"))
    read_s = register_s = 0.0
    processed = 0
    t0 = time.perf_counter()
    for raw in mux:
        if args.max_frames and processed >= args.max_frames:
            break
        msg = decode_message(raw)
        if args.use_2d_lidar:
            if not isinstance(msg, LaserScan):
                continue
            msg = project_laser(msg)
        if not isinstance(msg, PointCloud2):
            continue
        t1 = time.perf_counter()
        read_s += t1 - t0
        result = server.register_message(msg, tf_buffer)
        t0 = time.perf_counter()
        register_s += t0 - t1
        if result is None:
            continue  # awaiting tf initialization
        processed += 1
        if progress:
            progress.update()
    read_s += time.perf_counter() - t0
    if progress:
        progress.close()

    # Output naming parity: <bag>_kinematic_icp_poses_tum.txt
    # (offline_node.cpp:44-50).
    t0 = time.perf_counter()
    first_bag = args.bags[0]
    stem = os.path.splitext(os.path.basename(first_bag))[0]
    out_dir = args.output_dir or os.path.dirname(os.path.abspath(first_bag))
    out_path = os.path.join(out_dir, f"{stem}_kinematic_icp_poses_tum.txt")
    server.write_tum(out_path)
    print(f"wrote {processed} poses to {out_path}")

    if args.visualize and server.poses_with_stamps:
        from .utils.viewer import write_html_viewer
        poses = np.stack([p for _, p in server.poses_with_stamps])
        html_path = os.path.join(out_dir, f"{stem}_kinematic_icp_view.html")
        write_html_viewer(html_path, title=stem,
                          local_map=server.local_map_pointcloud(),
                          trajectory=poses)
        print(f"wrote viewer to {html_path}")
    if timings is not None:
        timings.update(read_s=read_s, register_s=register_s,
                       write_s=time.perf_counter() - t0, frames=processed,
                       registered=server.frames_registered)
    return out_path


def main(argv=None, timings: dict | None = None):
    args = build_arg_parser().parse_args(argv)
    return run(args, timings)


if __name__ == "__main__":
    main()
