"""Where the PyTorch port's offline main path spends its time on the card.

Usage (on a machine with a CUDA card):

    python3 tools/profile_torch_main_path.py [--frames 20]
        [--config headline|stock|exact] [--batch B] [--out FILE]

Runs ``kinematic_icp_tpu_torch.offline.run_offline`` at the headline shape
of ``chip_smoke.py`` (``--config stock``: its stock ``Config``, 8,192 ICP
source slots a frame; ``--config exact``: its reference-exact
configuration, the certified solve with the full-27 fallback) on synthetic
realistic scans under ``torch.profiler`` and prints one JSON line: wall
time per frame, device kernel time per frame, the device's busy and idle
share of the wall time, kernel launches per frame, and the ops that take
the most device time.  Where the profiler records no device activity the
device fields are null.

With ``--batch B`` the profiled run is ``offline.make_batched_sequence_
runner`` advancing B copies of the drive in lock-step (inputs padded and
uploaded as ``run_offline`` does); "a frame" is then a batched frame of B
sequences, and the line adds the sequences' aggregate frames per second.

With ``--config exact`` a second, unprofiled pass over the same frames,
on the eager loop (a replayed frame runs no Python to time), times each
registration (``compute_robot_motion``, synchronised before and after)
and reports the median wall time of frames whose certificate held and of
frames that fell back to the full-27 loop.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _registration_times(torch, np, frames, rels, cfg, extrinsic):
    """Median wall ms of one registration on frames whose certificate held
    and on frames that fell back, with the count of each, on the eager
    frame loop."""
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import (make_sequence_runner,
                                                 pad_sequence)
    from kinematic_icp_tpu_torch.ops import registration

    solve = registration.compute_robot_motion
    times = {False: [], True: []}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose, debug = solve(*args, **kwargs)
        fell_back = bool(debug.exact_fallback)
        torch.cuda.synchronize()
        times[fell_back].append((time.perf_counter() - t0) * 1e3)
        return pose, debug

    dev = torch.device("cuda")
    arrays = [torch.from_numpy(a).to(dev)
              for a in pad_sequence(frames, rels, cfg)]
    ext = torch.tensor(np.asarray(extrinsic, np.float32), device=dev)
    registration.compute_robot_motion = timed
    try:
        make_sequence_runner(cfg, dev, eager=True)(
            pipeline.init_state(cfg, device=dev), *arrays[:4], ext,
            arrays[4])
    finally:
        registration.compute_robot_motion = solve

    def median(v):
        return sorted(v)[len(v) // 2] if v else None

    return {"passing_frames": len(times[False]),
            "passing_median_ms": median(times[False]),
            "fallback_frames": len(times[True]),
            "fallback_median_ms": median(times[True])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--config", choices=("headline", "stock", "exact"),
                    default="headline")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile the batched runner over this many copies "
                         "of the drive (0: run_offline)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (EXACT, HEADLINE, STOCK, nvidia_smi_line,
                            run_batched)
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import run_offline
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.profiling import union_length

    if not torch.cuda.is_available():
        print("profile: no CUDA card", file=sys.stderr)
        return 1
    config_kw = {"headline": HEADLINE, "stock": STOCK,
                 "exact": EXACT}[args.config]
    cfg = Config(**config_kw)
    seq = synthetic.make_sequence(args.frames,
                                  lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    frames, rels = seq["frames"], seq["rel_odometry"]

    def drive(count):
        if args.batch:
            run_batched(torch, np, [seq] * args.batch, cfg, count)
        else:
            run_offline(frames[:count], rels[:count], cfg,
                        extrinsic=seq["extrinsic"])

    drive(3)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(len(frames))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    f = len(frames)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy = union_length([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    gn_us = sum(e.time_range.elapsed_us() for e in kernels
                if "gn_solve_kernel" in e.name)
    top = {}
    for e in kernels:
        t = top.setdefault(e.name[:80], [0.0, 0])
        t[0] += e.time_range.elapsed_us()
        t[1] += 1
    top = sorted(top.items(), key=lambda kv: -kv[1][0])[:12]
    measured = bool(kernels)
    row = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(), "frames": f,
        "config": config_kw, "batch": args.batch,
        "sequence_frames_per_s": max(args.batch, 1) * f / wall_us * 1e6,
        "wall_ms_per_frame": wall_us / f / 1e3,
        "device_kernel_ms_per_frame": kernel_us / f / 1e3 if measured
        else None,
        "device_busy_share": busy / wall_us if measured else None,
        "device_idle_share": 1.0 - busy / wall_us if measured else None,
        "kernel_launches_per_frame": len(kernels) / f if measured else None,
        "gn_kernel_ms_per_frame": gn_us / f / 1e3 if measured else None,
        "top_device_ops": [
            {"name": name, "ms_per_frame": us / f / 1e3,
             "launches_per_frame": n / f} for name, (us, n) in top],
    }
    if args.config == "exact" and not args.batch:
        row["registration_wall_ms"] = _registration_times(
            torch, np, frames, rels, cfg, seq["extrinsic"])
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
