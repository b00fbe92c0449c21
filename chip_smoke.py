"""Run the PyTorch/CUDA port on one NVIDIA card and hold it to its checks.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero before the
last line.  Phases:

  1. environment: the card, torch and CUDA versions;
  2. build: every kernel of the main path, compiled from ``csrc/`` by nvcc;
  3. gn_solve: the CUDA kernel against its plain PyTorch version on the
     card at three shapes (main path V=10 K=20 N=1024; stock Config
     N=8192; exact-mode V=27 with the crossing certificate), with timings;
  4. main path: ``offline.run_offline`` on a synthetic drive of realistic
     58K-point scans at the headline shape, with every kernel's launch
     count read around that one run, accuracy against ground truth, and
     the same frames through the plain GN version on the card;
  5. the ``kernels`` summary line, the card's name and power limit, and
     the final ``{"ok": true, ...}`` line.

It imports nothing of JAX; it needs one card and exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

#: the card's peak rates for the bound (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: headline shape (the JAX bench's realistic regime)
HEADLINE = dict(max_points=65536, max_downsampled=8192, max_source=1024,
                map_capacity=5 << 14, max_probes=5, voxel_size=1.0,
                max_range=60.0, deskew=True)
#: the estimate settles after a start-up transient, in which it trails
#: dead reckoning; over 60 frames it beats it (the main-path line also
#: reports the first EARLY_FRAMES frames)
MAIN_FRAMES = 60
EARLY_FRAMES = 20
TIMED_RUNS = 20
CALLS_PER_RUN = 10


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, runs=TIMED_RUNS, calls=CALLS_PER_RUN):
    """Median over ``runs`` of the device time per call of ``fn``, each run
    ``calls`` calls back to back between two CUDA events, so that the host
    queues the next call while the card runs the last one."""
    import torch
    fn()  # warm-up
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def err_tolerance(pose, guess, max_range, pose_diff):
    """How far the point-space error 2 R sqrt(h) + |dt| may move when the
    pose moves by ``pose_diff``.

    Kernel and plain version round each element alike (-fmad=false), so
    only the pose difference that the order of the sums leaves propagates:
    h = (1 - c)/2, with c from the nine-product trace of Rg^T R, moves by
    3/4 * pose_diff, and sqrt turns dh into R dh / sqrt(h).  With equal
    poses this is 0 and the 1e-5 relative floor alone applies.
    """
    import numpy as np
    frob = float(np.sum(pose[:3, :3].astype(np.float64)
                        * guess[:3, :3].astype(np.float64)))
    h = max((1.0 - (frob - 1.0) * 0.5) * 0.5, 0.0)
    dh = 3.0 * pose_diff / 4.0
    dsqrt = min(dh / max(np.sqrt(h), 1e-30), np.sqrt(dh))
    return 2.0 * max_range * dsqrt + 3.0 * pose_diff


def gn_bound(v, k, n, iterations):
    """(bound_ms, bound_by, bytes, flops) of one solve with this run's
    iteration count: inputs read once, outputs written once; per selection
    pass ~17 float ops per candidate (unpack 9, distance 8) and ~60 per
    query (transform, gate, normal-equation terms)."""
    nbytes = (v * k * n * 4 + v * n * 4 + 3 * n * 4   # words, rel, base
              + 3 * n * 4 + n                         # source, mask
              + 64 + 4                                # guess, tau
              + 64 + 4 + 4 + 4 + 1)                   # outputs
    passes = iterations + 1
    flops = passes * (17 * v * k * n + 60 * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def kernel_phase(torch, np, seq, v, n, check_crossing):
    from kinematic_icp_tpu_torch.ops import gn, hashmap
    from kinematic_icp_tpu_torch.ops.points import P3, transform

    dev = torch.device("cuda")
    rng = np.random.default_rng(1000 + v + n)
    # the map: the port's own insert of one realistic scan (~58K points)
    pts0 = torch.from_numpy(seq["frames"][0][0]).to(dev)
    m = hashmap.empty(HEADLINE["map_capacity"], 20,
                      bucket_slots=HEADLINE["max_probes"], device=dev)
    m, failed = hashmap.insert(m, P3.from_array(pts0),
                               torch.ones(len(pts0), dtype=torch.bool,
                                          device=dev), 1.0, 5,
                               max_extent=120.0, return_failed=True)
    # sources: scan points near the map, a guess a few cm / 10 mrad off
    all_pts = seq["frames"][0][0]
    pick = rng.choice(len(all_pts), n, replace=False)
    src = (all_pts[pick] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    source = P3.from_array(torch.from_numpy(src).to(dev))
    mask = torch.from_numpy(rng.uniform(size=n) < 0.95).to(dev)
    c, s = np.cos(0.01), np.sin(0.01)
    guess_np = np.array([[c, -s, 0, 0.03], [s, c, 0, -0.02], [0, 0, 1, 0],
                         [0, 0, 0, 1]], np.float32)
    guess = torch.from_numpy(guess_np).to(dev)
    cand = hashmap.gather_candidates(m, transform(guess, source), 1.0, 5, v)
    tau = 0.7 if check_crossing else 0.5
    kw = dict(voxel_size=1.0, max_num_iterations=10,
              convergence_criterion=0.001, use_adaptive_regularization=True,
              fixed_regularization=0.0, max_range=HEADLINE["max_range"],
              check_crossing=check_crossing)

    before = gn.LAUNCHES
    out_k = gn.gn_solve(cand, source, mask, guess, tau, backend="cuda", **kw)
    torch.cuda.synchronize()
    launches_per_solve = gn.LAUNCHES - before
    out_p = gn.gn_solve(cand, source, mask, guess, tau, backend="torch", **kw)
    torch.cuda.synchronize()

    pk, pp = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    pose_err = float(np.abs(pk - pp).max())
    ints_k = [int(out_k[i]) for i in (1, 2, 4)]
    ints_p = [int(out_p[i]) for i in (1, 2, 4)]
    err_k, err_p = float(out_k[3]), float(out_p[3])
    err_tol = 1e-5 * abs(err_p) + err_tolerance(pp, guess_np,
                                                HEADLINE["max_range"],
                                                pose_err)
    ok = (pose_err <= 1e-5 and ints_k == ints_p
          and abs(err_k - err_p) <= err_tol and launches_per_solve == 1
          and ints_k[1] > 0)

    kernel_ms = median_ms(lambda: gn.gn_solve(cand, source, mask, guess, tau,
                                              backend="cuda", **kw))
    plain_ms = median_ms(lambda: gn.gn_solve(cand, source, mask, guess, tau,
                                             backend="torch", **kw))
    bound_ms, bound_by, nbytes, flops = gn_bound(v, 20, n, ints_k[0])
    row = {"phase": "gn_solve", "V": v, "K": 20, "N": n,
           "check_crossing": check_crossing, "map_insert_failed": int(failed),
           "iterations": ints_k[0], "correspondences": ints_k[1],
           "crossed": bool(ints_k[2]), "plain": ints_p,
           "max_abs_err_pose": pose_err, "err": err_k, "err_plain": err_p,
           "err_tol": err_tol, "launches_per_solve": launches_per_solve,
           "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_bytes": nbytes, "bound_flops": flops,
           "library_ms": None, "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit(f"gn_solve kernel disagrees with its plain version "
                         f"at V={v} N={n}")
    return row


def main_path_phase(torch, np, seq):
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import run_offline
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**HEADLINE)
    frames, rels = seq["frames"], seq["rel_odometry"]
    gt = seq["gt_poses"]

    def drive(config, count=len(frames)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            poses, _ = run_offline(frames[:count], rels[:count], config,
                                   extrinsic=seq["extrinsic"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        overflow = [str(w.message) for w in caught
                    if "capacity overflow" in str(w.message)]
        return poses, seconds, overflow

    drive(cfg, 3)  # warm-up: CUDA context, allocator, library load
    torch.cuda.reset_peak_memory_stats()
    gn.LAUNCHES = 0
    poses, seconds, overflow = drive(cfg)
    launches = gn.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    dead = [np.eye(4)]
    for rel in rels[1:]:
        dead.append(dead[-1] @ rel)
    ate = ate_rmse(gt, poses, align=False)
    ate_dead = ate_rmse(gt, dead, align=False)
    # the start-up transient, for the record (not a check)
    early = {"ate_vs_gt_m": ate_rmse(gt[:EARLY_FRAMES], poses[:EARLY_FRAMES],
                                     align=False),
             "ate_dead_reckoning_m": ate_rmse(gt[:EARLY_FRAMES],
                                              dead[:EARLY_FRAMES],
                                              align=False)}
    poses_plain, seconds_plain, overflow_plain = drive(
        cfg.replace(gn_backend="torch"))
    ate_plain = ate_rmse(poses_plain, poses, align=False)
    checks = {
        "finite": bool(np.isfinite(poses).all()),
        "zero_overflow": not overflow and not overflow_plain,
        "kernel_every_frame": launches == len(frames),
        "beats_dead_reckoning": ate < ate_dead,
        "plain_within_5mm": ate_plain < 5e-3,
    }
    row = {"phase": "main_path", "frames": len(frames),
           "mean_points": float(np.mean([len(f[0]) for f in frames])),
           "config": HEADLINE, "gn_launches": launches,
           "overflow": overflow or [0, 0, 0], "frames_per_s":
           len(frames) / seconds, "seconds": seconds,
           "plain_frames_per_s": len(frames) / seconds_plain,
           "peak_memory_bytes": peak, "ate_vs_gt_m": ate,
           "ate_dead_reckoning_m": ate_dead, "ate_kernel_vs_plain_m":
           ate_plain, f"first_{EARLY_FRAMES}_frames": early,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"main path failed: {checks}")
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from kinematic_icp_tpu_torch.ops import cuda_build
    from kinematic_icp_tpu_torch.utils import synthetic

    card = nvidia_smi_line()
    emit({"phase": "environment", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    built = cuda_build.build("gn_solve")
    emit({"phase": "build", "kernels": {
        name: {"seconds": b["seconds"],
               "ptxas": [ln.strip() for ln in b["log"].splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, b in built.items()}})

    seq = synthetic.make_sequence(MAIN_FRAMES,
                                  lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    main_shape = kernel_phase(torch, np, seq, 10, 1024, False)
    kernel_phase(torch, np, seq, 10, 8192, False)
    kernel_phase(torch, np, seq, 27, 1024, True)

    launches = main_path_phase(torch, np, seq)

    emit({"kernels": [{
        "name": "gn_solve", "route": "cuda",
        "source": "kinematic_icp_tpu_torch/csrc/gn_solve.cu",
        "replaces": "kinematic_icp_tpu/ops/pallas_gn.py:86",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err_pose"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
