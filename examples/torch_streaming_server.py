"""Serving through the PyTorch/CUDA port: blocking against streaming.

The port's counterpart of ``examples/streaming_server.py``.  The same drive
goes through ``server.LidarOdometryServer`` twice:

  * blocking: one packed upload, one step (a CUDA graph replay on a card)
    and one readback a frame, the reference's one ``RegisterFrame`` per
    scan (lowest latency a pose);
  * streaming: ``register_frame(blocking=False)`` stages ``stream_chunk=8``
    frames a host-to-device transfer and ``drain()`` settles the poses in
    one read (highest throughput).

Under the default ``stream_mode="steps"`` the two trajectories are
bit-equal by construction (the same step runs on the same packed bytes);
the script checks it and prints both rates.

Usage:

    python examples/torch_streaming_server.py [--frames 30]
    python examples/torch_streaming_server.py --device cpu --small --frames 5

``--device`` defaults to ``cuda`` and never falls back to the CPU.
``--small`` drives a small sensor and ``Config`` that runs on the CPU in
seconds.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch.server import LidarOdometryServer, next_bucket
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

#: examples/streaming_server.py's configuration
CONFIG = dict(max_points=4096, max_downsampled=4096, max_source=1024,
              map_capacity=1 << 13, voxel_size=1.0, max_range=60.0,
              deskew=True)
#: --small: a 1,024-ray sensor and a configuration sized to it
SMALL = dict(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0,
             max_probes=4, deskew=True)
SMALL_LIDAR = dict(num_beams=256, num_rings=4,
                   ring_angles_deg=(-10.0, -3.0, 0.0, 8.0))
STREAM_CHUNK = 8


def drive(server, seq, blocking):
    """Seconds to register every frame (and, streaming, to drain)."""
    for bucket in {next_bucket(len(p), server.config.max_points)
                   for p, _ in seq["frames"]}:
        server.warmup(bucket, streaming=not blocking)
    t0 = time.perf_counter()
    for i, (pts, ts) in enumerate(seq["frames"]):
        server.register_frame(pts, ts, seq["rel_odometry"][i],
                              stamp=0.1 * (i + 1), blocking=blocking)
    server.drain()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small sensor and Config (seconds on the CPU)")
    args = ap.parse_args(argv)

    cfg = Config(**(SMALL if args.small else CONFIG))
    seq = synthetic.make_sequence(
        args.frames,
        lidar=synthetic.LidarModel(**SMALL_LIDAR) if args.small else None)

    blocking = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"],
                                   device=args.device)
    dt_b = drive(blocking, seq, blocking=True)
    streaming = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"],
                                    stream_chunk=STREAM_CHUNK,
                                    device=args.device)
    dt_s = drive(streaming, seq, blocking=False)

    pb = np.asarray([p for _, p in blocking.poses_with_stamps])
    ps = np.asarray([p for _, p in streaming.poses_with_stamps])
    ate = ate_rmse(seq["gt_poses"], list(pb), align=False)
    print(f"device={blocking.device} frames={args.frames}  "
          f"blocking {args.frames / dt_b:.1f} frames/s  "
          f"streaming {args.frames / dt_s:.1f} frames/s "
          f"({STREAM_CHUNK} frames a transfer)")
    print(f"ATE vs ground truth {ate:.4f} m; overflow stats: "
          f"{blocking.overflow_stats}")
    if pb.shape != ps.shape or not np.array_equal(pb, ps):
        print("streaming poses differ from blocking ones", file=sys.stderr)
        return 1
    print("trajectories bit-equal")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
