"""A synthetic drive through the PyTorch/CUDA port: odometry -> ATE report.

The port's counterpart of ``examples/synthetic_drive.py``: a wall world,
noisy wheel odometry, every scan registered by ``server.LidarOdometryServer``
(blocking, one CUDA graph replay a frame on a card), then the estimate's
ATE and RPE against ground truth beside dead reckoning's.

Usage:

    python examples/torch_synthetic_drive.py [--frames 40]
    python examples/torch_synthetic_drive.py --device cpu --small --frames 5

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
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse, rpe

#: examples/synthetic_drive.py's configuration
CONFIG = dict(max_points=16384, max_downsampled=8192, max_source=4096,
              map_capacity=1 << 16, voxel_size=1.0, max_range=60.0,
              deskew=True)
#: --small: a 1,024-ray sensor and a configuration sized to it
SMALL = dict(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0,
             max_probes=4, deskew=True)
SMALL_LIDAR = dict(num_beams=256, num_rings=4,
                   ring_angles_deg=(-10.0, -3.0, 0.0, 8.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small sensor and Config (seconds on the CPU)")
    args = ap.parse_args(argv)

    cfg = Config(**(SMALL if args.small else CONFIG))
    seq = synthetic.make_sequence(
        args.frames,
        lidar=synthetic.LidarModel(**SMALL_LIDAR) if args.small else None)
    server = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"],
                                 device=args.device)
    # capture each bucket's step before the clock (on a card)
    for bucket in {next_bucket(len(p), cfg.max_points)
                   for p, _ in seq["frames"]}:
        server.warmup(bucket)

    dead_pose = np.eye(4)
    dead_poses = []
    t0 = time.perf_counter()
    for k, (pts, ts) in enumerate(seq["frames"]):
        rel = seq["rel_odometry"][k]
        server.register_frame(pts, ts, rel, stamp=0.1 * k)
        dead_pose = dead_pose @ rel
        dead_poses.append(dead_pose.copy())
    elapsed = time.perf_counter() - t0

    est = [p for _, p in server.poses_with_stamps]
    gt = seq["gt_poses"]
    ate = ate_rmse(gt, est, align=False)
    ate_dead = ate_rmse(gt, dead_poses, align=False)
    rpe_t, rpe_r = rpe(gt, est)
    print(f"device={server.device} frames={args.frames} "
          f"rate={args.frames / elapsed:.2f} frames/s")
    print(f"ATE  icp={ate:.4f} m   dead-reckoning={ate_dead:.4f} m")
    print(f"RPE  trans={rpe_t:.4f} m  rot={np.degrees(rpe_r):.3f} deg")
    print(f"overflow stats: {server.overflow_stats}")
    if not (ate < 0.5 * ate_dead or ate < 0.05):
        print(f"odometry ({ate:.3f} m) should beat dead reckoning "
              f"({ate_dead:.3f} m)", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
