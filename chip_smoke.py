"""Run the PyTorch/CUDA port on one NVIDIA card and hold it to its checks.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero before the
last line.  Phases:

  1. environment: the card, torch and CUDA versions;
  2. build: every kernel of the main path, compiled from ``csrc/`` by nvcc;
     fails if ptxas reports any spill;
  3. gn_solve: the CUDA kernel against its plain PyTorch version on the
     card at three shapes (main path V=10 K=20 N=1024; stock Config
     N=8192; exact-mode V=27 with the crossing certificate), with its
     cooperative grid size, a bit-equality check of two launches, timings
     and the single-CTA design's times (``tools/gn_kernel_pace.py`` splits
     a solve's time into launch, fixed per-pass cost and row scan);
  4. main path: ``offline.run_offline`` on a synthetic drive of realistic
     58K-point scans at the headline shape, with every kernel's launch
     count read around that one run, accuracy against ground truth, and
     the same frames through the torch loop lowering (``gn_backend=
     "torch"``) on the card;
  5. stock Config: 20 frames of the same drive under ``Config(deskew=True,
     max_range=60.0)`` (8,192 ICP source slots a frame), the kernel on
     every frame, zero overflow, and the loop lowering's trajectory;
  6. exact mode: the 60 headline frames under the JAX bench's
     reference-exact configuration (27 voxels re-gathered every GN
     iteration): the kernel's certified solve (its ``check_crossing``
     instance) on every frame with the full-27 loop on the frames whose
     certificate fails, zero overflow, better than dead reckoning, and
     within 5 mm of the full-27 loop on every frame;
  7. exact fallback: one frame whose certificate must fail, through
     ``compute_robot_motion``, equal to the full-27 loop;
  8. pruned exact: 20 frames with 14 of 27 voxels re-gathered and the
     certificate, bit-equal to the full-27 loop on every frame;
  9. batched: the GN kernel solving 8 frames in one launch at N=1024 and
     N=8192 (each frame bit-equal to its own single launch, equal to the
     plain version); 8 distinct headline drives (one cut to 44 frames)
     through ``offline.make_batched_sequence_runner`` (one GN launch a
     batched frame, zero overflow, each drive within 5 mm of its own
     ``run_offline``, the short drive's pose held over its padding; each
     drive's ATE against its dead reckoning is reported); aggregate
     frames/s, device launches a batched frame and peak memory at B = 1,
     2, 8, 16; and
     ``parallel.BatchedOdometryRunner`` (``run`` against ``run_device``,
     a stationary gate other than 1e-3, the raise on too many sequences);
     and a batch one frame larger than the card's co-resident CTAs (two
     launches, every frame bit-equal to its own single launch);
 10. serve: ``server.LidarOdometryServer`` over the 60 headline frames,
     one JSON line per sub-phase: blocking (per-frame latency p50/p90/p99,
     frames/s, one GN launch per registered frame, zero overflow, better
     than dead reckoning, within 5 mm of the main path's ``run_offline``
     poses, peak memory); streaming ``"steps"`` (bit-equal to blocking)
     and ``"scan"`` (within 1e-6 of "steps"), 8 frames a chunk; the ``u16``
     upload codec (ATE < 0.02 m against the f32 server); a checkpoint
     saved at frame 30 and resumed by a fresh server (bit-equal to the
     uninterrupted run); ``online.OnlineOdometryNode`` over 20 frames
     of in-memory messages (PointCloud2 with per-point stamps, ``/tf``
     wheel odometry, ``/tf_static`` extrinsic); and a float64 server over
     20 frames (one GN launch per registered frame, within 5 mm of the
     float32 server);
 11. cli: ``run_odometry.main`` (the offline CLI) over the 60 headline
     frames written to an uncompressed mcap by the port's writer (one GN
     launch per registered frame, the native ingestion library loaded,
     better than dead reckoning, within the 0.0251 m self-divergence floor
     of ``run_offline``'s poses, ``evaluate`` against a ground-truth TUM,
     frames/s and the wall split into read/decode, register and write),
     then 20 frames of the 2D LaserScan topic through ``--use-2d-lidar``;
 12. oracle: ``run_offline`` on the card against the port's float64
     ``OracleKinematicICP`` over tests/test_differential.py's drive and
     bounds, and the native C++ baseline (built here from
     ``native/kicp_baseline.cpp``) over the 60 headline frames, within
     tests/test_differential.py:137's bound of this drive's own
     self-divergence (the baseline against itself with 1 um of noise and
     on two permutations of the points);
 13. the ``kernels`` summary line, the card's name and power limit, and
     the final ``{"ok": true, ...}`` line.

It imports nothing of JAX; it needs one card and exits non-zero without one.
"""

from __future__ import annotations

import json
import re
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
#: the reference's default Config, but for deskew and the 60 m range of
#: the synthetic sensor: max_source 8192, max_downsampled 16384,
#: map_capacity 1 << 18
STOCK = dict(deskew=True, max_range=60.0)
STOCK_FRAMES = 20
#: the JAX bench's reference-exact configuration (bench.py:296-298)
EXACT = dict(HEADLINE, neighbor_candidates=27, exact_gn_reassociation=True,
             map_capacity=1 << 16, max_probes=4)
EXACT_FRAMES = 60
#: pruned exact runs on the loop lowering only, as in the JAX package
PRUNED = dict(EXACT, exact_prune_candidates=14, gn_backend="torch")
PRUNED_FRAMES = 20
#: the serve phase: frames a streaming chunk, the checkpoint's frame, the
#: online node's frames, the scan period (s) the frames are stamped with
SERVE_CHUNK = 8
SERVE_CHECKPOINT_FRAME = 30
ONLINE_FRAMES = 20
SCAN_PERIOD = 0.1
#: the single-CTA design's kernel ms at each (V, N, check_crossing) on an
#: NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6)
EARLIER_MS = {(10, 1024, False): 0.3212, (10, 8192, False): 2.591,
              (27, 1024, True): 0.890}
TIMED_RUNS = 20
CALLS_PER_RUN = 10
#: the batched phase: drives a batch, the frames of the short one (the
#: rest run MAIN_FRAMES), the swept batch sizes with their frames and
#: profiled frames, and the frames of BatchedOdometryRunner's drives
BATCH = 8
BATCH_SHORT = 44
SWEEP_BATCHES = (1, 2, 8, 16)
SWEEP_FRAMES = 20
PROFILED_FRAMES = 5
RUNNER_FRAMES = 20
#: the float64 served drive's frames
FLOAT64_FRAMES = 20
#: the cli phase: the 2D drive's frames, its LaserScan topic and point
#: capacity (tests/test_aux.py:38-41), and the self-divergence floor of the
#: reference on the JAX bench's headline drive (PARITY.md:98), which bounds
#: the CLI against run_offline
CLI_2D_FRAMES = 20
SCAN_2D_TOPIC = "/front_scan"
CLI_2D_MAX_POINTS = 4096
FLOOR_M = 0.0251
#: the oracle phase: tests/test_differential.py's configuration, frames and
#: bounds
DIFF = dict(max_points=8192, max_downsampled=8192, max_source=4096,
            map_capacity=1 << 15, voxel_size=1.0, max_range=60.0, deskew=True)
DIFF_FRAMES = 15
DIFF_ATE_M = 0.02
DIFF_FRAME_M = 0.05


#: the script's start, for each phase line's ``elapsed_s``
T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, runs=TIMED_RUNS, calls=CALLS_PER_RUN):
    """Median over ``runs`` of the device time per call of ``fn``, each run
    ``calls`` calls back to back between two CUDA events.

    A spin kernel (``torch.cuda._sleep``) runs first, longer than the host
    takes to issue the run's calls, so the events time the calls' device
    work back to back and not the host's issue rate (which sets the pace of
    a kernel this short)."""
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # at most 2 GHz (the H100's SM clock is at most 1.98 GHz), so the spin
    # lasts at least twice the measured issue time of the run
    cycles = int(2.0 * calls * issue_s * 2e9)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


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


def gn_problem(torch, np, seq, v, n, check_crossing, seed=0):
    """One frame's GN solve on the card at (V, K=20, N): the map is one
    realistic scan, the sources noisy scan points, the guess a few cm and
    10 mrad off (``seed`` > 0: other sources and a guess further off).
    Returns (args, kwargs, guess as numpy, map insert failures) for
    ``gn.gn_solve``."""
    from kinematic_icp_tpu_torch.ops import hashmap
    from kinematic_icp_tpu_torch.ops.points import P3, transform

    dev = torch.device("cuda")
    rng = np.random.default_rng(1000 + v + n + 7919 * seed)
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
    yaw, tx, ty = 0.01 + 0.004 * seed, 0.03 + 0.02 * seed, -0.02 + 0.01 * seed
    c, s = np.cos(yaw), np.sin(yaw)
    guess_np = np.array([[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, 0],
                         [0, 0, 0, 1]], np.float32)
    guess = torch.from_numpy(guess_np).to(dev)
    cand = hashmap.gather_candidates(m, transform(guess, source), 1.0, 5, v)
    # a 0-d tensor on the card, as the main path passes it
    tau = torch.tensor(0.7 if check_crossing else 0.5, device=dev)
    kw = dict(voxel_size=1.0, max_num_iterations=10,
              convergence_criterion=0.001, use_adaptive_regularization=True,
              fixed_regularization=0.0, max_range=HEADLINE["max_range"],
              check_crossing=check_crossing)
    return (cand, source, mask, guess, tau), kw, guess_np, int(failed)


def kernel_phase(torch, np, seq, v, n, check_crossing):
    from kinematic_icp_tpu_torch.ops import gn

    (cand, source, mask, guess, tau), kw, guess_np, failed = gn_problem(
        torch, np, seq, v, n, check_crossing)
    before = gn.LAUNCHES
    out_k = gn.gn_solve(cand, source, mask, guess, tau, backend="cuda", **kw)
    torch.cuda.synchronize()
    launches_per_solve = gn.LAUNCHES - before
    ctas = gn.LAST_CTAS
    out_k2 = gn.gn_solve(cand, source, mask, guess, tau, backend="cuda", **kw)
    out_p = gn.gn_solve(cand, source, mask, guess, tau, backend="torch", **kw)
    torch.cuda.synchronize()
    deterministic = all(
        torch.equal(a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8))
        for a, b in zip(out_k, out_k2))

    pk, pp = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    pose_err = float(np.abs(pk - pp).max())
    ints_k = [int(out_k[i]) for i in (1, 2, 4)]
    ints_p = [int(out_p[i]) for i in (1, 2, 4)]
    err_k, err_p = float(out_k[3]), float(out_p[3])
    # kernel and plain version round each element alike (-fmad=false), so
    # only the pose difference that the order of the sums leaves moves the
    # error, by its conditioning; plus a 1e-5 relative floor
    err_tol = 1e-5 * abs(err_p) + gn.error_tolerance(
        pp, guess_np, HEADLINE["max_range"], pose_err)
    ok = (pose_err <= 1e-5 and ints_k == ints_p
          and abs(err_k - err_p) <= err_tol and launches_per_solve == 1
          and ints_k[1] > 0 and deterministic and ctas > 1)

    kernel_ms = median_ms(lambda: gn.gn_solve(cand, source, mask, guess, tau,
                                              backend="cuda", **kw))
    # the plain version issues hundreds of launches a call: fewer runs
    plain_ms = median_ms(lambda: gn.gn_solve(cand, source, mask, guess, tau,
                                             backend="torch", **kw), runs=5)
    bound_ms, bound_by, nbytes, flops = gn_bound(v, 20, n, ints_k[0])
    row = {"phase": "gn_solve", "V": v, "K": 20, "N": n,
           "check_crossing": check_crossing, "map_insert_failed": failed,
           "iterations": ints_k[0], "correspondences": ints_k[1],
           "crossed": bool(ints_k[2]), "plain": ints_p,
           "max_abs_err_pose": pose_err, "err": err_k, "err_plain": err_p,
           "err_tol": err_tol, "launches_per_solve": launches_per_solve,
           "ctas": ctas, "deterministic": deterministic,
           "ms": kernel_ms, "earlier_ms": EARLIER_MS[(v, n, check_crossing)],
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_bytes": nbytes, "bound_flops": flops,
           "library_ms": None, "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit(f"gn_solve kernel disagrees with its plain version "
                         f"at V={v} N={n}")
    return row


def run_drive(torch, seq, config, n):
    """``run_offline`` over the first ``n`` frames on the card.  Returns
    (poses, seconds, overflow warnings, stats)."""
    from kinematic_icp_tpu_torch.offline import run_offline

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        poses, _, stats = run_offline(seq["frames"][:n],
                                      seq["rel_odometry"][:n], config,
                                      extrinsic=seq["extrinsic"],
                                      return_stats=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    overflow = [str(w.message) for w in caught
                if "capacity overflow" in str(w.message)]
    return poses, seconds, overflow, stats


def dead_reckoning(np, rels):
    dead = [np.eye(4)]
    for rel in rels[1:]:
        dead.append(dead[-1] @ rel)
    return dead


def drive_phase(torch, np, seq, phase, config_kw, count, judge_vs_gt,
                judge=None):
    """``run_offline`` over the first ``count`` frames under ``config_kw``,
    with the GN launch counts set to 0 just before and read just after,
    then the same frames through the loop lowering (``gn_backend=
    "torch"``) on the card.  ``judge(row, poses)`` adds a phase's own
    fields to ``row`` and returns its own checks.

    ``judge_vs_gt``: also require the estimate to beat dead reckoning
    against ground truth (a drive long enough to settle).  Returns (row,
    poses); the row holds the GN launch counts and the fallback totals."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**config_kw)
    frames = seq["frames"][:count]
    gt = seq["gt_poses"][:count]

    run_drive(torch, seq, cfg, 3)  # warm-up: context, allocator, library
    torch.cuda.reset_peak_memory_stats()
    gn.LAUNCHES = 0
    gn.CROSSING_LAUNCHES = 0
    poses, seconds, overflow, stats = run_drive(torch, seq, cfg, count)
    launches, crossing = gn.LAUNCHES, gn.CROSSING_LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    dead = dead_reckoning(np, seq["rel_odometry"][:count])
    ate = ate_rmse(gt, poses, align=False)
    ate_dead = ate_rmse(gt, dead, align=False)
    poses_loop, seconds_loop, overflow_loop, stats_loop = run_drive(
        torch, seq, cfg.replace(gn_backend="torch"), count)
    ate_loop = ate_rmse(poses_loop, poses, align=False)
    row = {"phase": phase, "frames": count,
           "mean_points": float(np.mean([len(f[0]) for f in frames])),
           "config": config_kw, "gn_launches": launches,
           "gn_check_crossing_launches": crossing,
           "exact_fallback_frames": stats["exact_fallback_frames"],
           "loop_exact_fallback_frames": stats_loop["exact_fallback_frames"],
           "overflow": overflow or [0, 0, 0], "frames_per_s":
           count / seconds, "seconds": seconds,
           "loop_frames_per_s": count / seconds_loop,
           "peak_memory_bytes": peak, "ate_vs_gt_m": ate,
           "ate_dead_reckoning_m": ate_dead, "ate_kernel_vs_loop_m":
           ate_loop}
    row["checks"] = {
        "finite": bool(np.isfinite(poses).all()),
        "zero_overflow": not overflow and not overflow_loop,
        "loop_within_5mm": ate_loop < 5e-3,
        **(judge(row, poses) if judge else
           {"kernel_every_frame": launches == count})}
    if judge_vs_gt:
        row["checks"]["beats_dead_reckoning"] = ate < ate_dead
        # the start-up transient, for the record (not a check)
        row[f"first_{EARLY_FRAMES}_frames"] = {
            "ate_vs_gt_m": ate_rmse(gt[:EARLY_FRAMES], poses[:EARLY_FRAMES],
                                    align=False),
            "ate_dead_reckoning_m": ate_rmse(gt[:EARLY_FRAMES],
                                             dead[:EARLY_FRAMES],
                                             align=False)}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"{phase} failed: {row['checks']}")
    return row, poses


def active_frames(torch, np, rels):
    """Frames past the stationary gate (``offline._per_frame_constants``)."""
    from kinematic_icp_tpu_torch.ops import se3

    logs = se3.se3_log(torch.tensor(np.stack(rels), dtype=torch.float32))
    return int((torch.linalg.vector_norm(logs, dim=-1) > 1e-3).sum())


def exact_phase(torch, np, seq, main_poses):
    """The reference-exact mode over the headline frames: the certified
    solve on every frame, then the full-27 loop on every frame.  Returns
    the ``check_crossing`` instance's launches."""
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    count = EXACT_FRAMES

    def judge(row, poses):
        row["active_frames"] = active_frames(torch, np,
                                             seq["rel_odometry"][:count])
        # the JAX bench's default_vs_exact_ate_m, for the record
        row["default_vs_exact_ate_m"] = ate_rmse(main_poses, poses,
                                                 align=False)
        # every frame registers (the stationary gate only masks the state
        # update), each through one launch of the certified instance
        return {"certified_kernel_every_frame": (
                    row["gn_check_crossing_launches"] == row["gn_launches"]
                    == count),
                "loop_never_falls_back":
                    row["loop_exact_fallback_frames"] == 0}

    row, _ = drive_phase(torch, np, seq, "exact_mode", EXACT, count, True,
                         judge=judge)
    return row["gn_check_crossing_launches"]


def fallback_phase(torch, np):
    """One frame whose certificate must fail (tests/test_pallas_gn.py:
    160-166: a uniform 3,000-point map, 512 noisy sources, a 0.45 m guess
    offset, tau 2.0) through ``compute_robot_motion``, against the full-27
    loop on the same card."""
    from kinematic_icp_tpu_torch.ops import gn, hashmap, registration
    from kinematic_icp_tpu_torch.ops.points import P3

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    map_pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    src = (map_pts[:512] + rng.normal(0, 0.05, (512, 3))).astype(np.float32)
    mask = torch.from_numpy(rng.uniform(size=512) < 0.9).to(dev)
    m = hashmap.insert(hashmap.empty(1 << 13, 20, device=dev),
                       P3.from_array(torch.from_numpy(map_pts).to(dev)),
                       torch.ones(3000, dtype=torch.bool, device=dev),
                       1.0, 4)
    source = P3.from_array(torch.from_numpy(src).to(dev))
    guess = torch.eye(4, device=dev)
    guess[0, 3] = 0.45
    kw = dict(voxel_size=1.0, max_probes=4, max_num_iterations=10,
              convergence_criterion=0.001,
              use_adaptive_odometry_regularization=True,
              fixed_regularization=0.0, threshold_max_range=60.0,
              exact_gn_reassociation=True)

    def solve(backend):
        return registration.compute_robot_motion(
            m, source, mask, torch.eye(4, device=dev), guess,
            torch.tensor(2.0, device=dev), gn_backend=backend, **kw)

    before = gn.CROSSING_LAUNCHES
    cert_pose, cert = solve("cuda")
    launched = gn.CROSSING_LAUNCHES - before
    loop_pose, loop = solve("torch")
    pose_err = float((cert_pose - loop_pose).abs().max())
    checks = {
        "exact_fallback": bool(cert.exact_fallback),
        "one_certified_launch": launched == 1,
        "pose_within_1e-6": pose_err <= 1e-6,
        "iterations_equal": int(cert.iterations) == int(loop.iterations),
        "correspondences_equal": int(cert.num_correspondences) == int(
            loop.num_correspondences),
    }
    emit({"phase": "exact_fallback", "iterations": int(cert.iterations),
          "correspondences": int(cert.num_correspondences),
          "max_abs_err_pose": pose_err, "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"exact_fallback failed: {checks}")


def pruned_phase(torch, np, seq):
    """Pruned exact over the first headline frames, against the full-27
    loop on the same frames: bit-equal poses on every frame."""
    from kinematic_icp_tpu_torch import Config

    cfg = Config(**PRUNED)
    count = PRUNED_FRAMES
    poses, seconds, overflow, stats = run_drive(torch, seq, cfg, count)
    full, seconds_full, overflow_full, _ = run_drive(
        torch, seq, cfg.replace(exact_prune_candidates=0), count)
    equal = sum(bool(np.array_equal(a, b)) for a, b in zip(poses, full))
    checks = {"finite": bool(np.isfinite(poses).all()),
              "zero_overflow": not overflow and not overflow_full,
              "bit_equal_every_frame": equal == count}
    emit({"phase": "pruned_exact", "frames": count, "config": PRUNED,
          "exact_fallback_frames": stats["exact_fallback_frames"],
          "frames_bit_equal": equal, "frames_per_s": count / seconds,
          "full_27_frames_per_s": count / seconds_full, "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"pruned_exact failed: {checks}")


def stack_frames(torch, problems):
    """B single-frame GN problems (``gn_problem``'s) -> one batched call's
    arguments."""
    from kinematic_icp_tpu_torch.ops.hashmap import CandidateSet
    from kinematic_icp_tpu_torch.ops.points import P3

    args = [p[0] for p in problems]
    cand = CandidateSet(*(torch.stack(t) for t in zip(*(a[0] for a in args))))
    source = P3(*(torch.stack(t) for t in zip(*(a[1] for a in args))))
    return (cand, source, torch.stack([a[2] for a in args]),
            torch.stack([a[3] for a in args]),
            torch.stack([a[4] for a in args]))


def bits_equal(torch, a, b):
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def batched_kernel_phase(torch, np, seq, v, n):
    """BATCH frames (their own sources and guesses, one map) solved in one
    launch: each frame bit-equal to its own single launch, equal to the
    plain version within the single-frame phase's tolerance, two batched
    launches bit-equal."""
    from kinematic_icp_tpu_torch.ops import gn

    problems = [gn_problem(torch, np, seq, v, n, False, seed=i)
                for i in range(BATCH)]
    args, kw = stack_frames(torch, problems), problems[0][1]
    before = (gn.LAUNCHES, gn.FRAMES)
    out = gn.gn_solve(*args, backend="cuda", **kw)
    torch.cuda.synchronize()
    launched = (gn.LAUNCHES - before[0], gn.FRAMES - before[1])
    ctas = gn.LAST_CTAS
    again = gn.gn_solve(*args, backend="cuda", **kw)
    singles = [gn.gn_solve(*p[0], backend="cuda", **kw) for p in problems]
    plain = gn.gn_solve(*args, backend="torch", **kw)
    torch.cuda.synchronize()
    deterministic = all(bits_equal(torch, a, b) for a, b in zip(out, again))
    frames_equal = sum(
        all(bits_equal(torch, x[i], y) for x, y in zip(out, one))
        for i, one in enumerate(singles))
    pk, pp = out[0].cpu().numpy(), plain[0].cpu().numpy()
    pose_err = float(np.abs(pk - pp).max())
    ints_k = [out[i].cpu().numpy().astype(int).tolist() for i in (1, 2, 4)]
    ints_p = [plain[i].cpu().numpy().astype(int).tolist() for i in (1, 2, 4)]
    err_k, err_p = out[3].cpu().numpy(), plain[3].cpu().numpy()
    err_ok = all(
        abs(float(err_k[i]) - float(err_p[i])) <= 1e-5 * abs(float(err_p[i]))
        + gn.error_tolerance(pp[i], problems[i][2], HEADLINE["max_range"],
                             float(np.abs(pk[i] - pp[i]).max()))
        for i in range(BATCH))
    iterations = ints_k[0]
    ms = median_ms(lambda: gn.gn_solve(*args, backend="cuda", **kw))
    single_ms = median_ms(lambda: gn.gn_solve(*problems[0][0],
                                              backend="cuda", **kw))
    plain_ms = median_ms(lambda: gn.gn_solve(*args, backend="torch", **kw),
                         runs=3, calls=2)
    bounds = [gn_bound(v, 20, n, it) for it in iterations]
    nbytes = sum(b[2] for b in bounds)
    flops = sum(b[3] for b in bounds)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    row = {"phase": "batched_gn_solve", "B": BATCH, "V": v, "K": 20, "N": n,
           "launches": launched[0], "frames_solved": launched[1],
           "ctas_per_frame": ctas, "ctas": ctas * BATCH,
           "tiles_per_frame": (n + 31) // 32, "iterations": iterations,
           "correspondences": ints_k[1], "plain": ints_p,
           "frames_bit_equal_to_single_launch": frames_equal,
           "deterministic": deterministic, "max_abs_err_pose": pose_err,
           "ms": ms, "ms_per_frame": ms / BATCH, "single_frame_ms": single_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes": nbytes, "bound_flops": flops, "library_ms": None}
    row["checks"] = {"one_launch_b_frames": launched == (1, BATCH),
                     "bit_equal_to_single_launches": frames_equal == BATCH,
                     "deterministic": deterministic,
                     "plain_within_tolerance": (pose_err <= 1e-5
                                                and ints_k == ints_p
                                                and err_ok)}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"batched gn_solve failed at V={v} N={n}: "
                         f"{row['checks']}")
    return row


def run_batched(torch, np, seqs, config, count, profile=False):
    """The batched sequence runner over the first ``count`` frames of
    ``seqs`` on the card (a shorter drive pads with stationary frames):
    pad, upload, run, read back (as ``run_offline`` does).  Returns
    (poses (F, B, 4, 4), overflow (B, 3), {"pad_s", "upload_s", "run_s",
    "seconds"}: host seconds of the numpy padding, of the uploads (to their
    end) and of the runner with the readback, and their sum, device
    launches a frame with ``profile``, else None)."""
    from kinematic_icp_tpu_torch.offline import (init_batched_state,
                                                 make_batched_sequence_runner,
                                                 pad_batch)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    padded = pad_batch([dict(s, frames=s["frames"][:count],
                             rel_odometry=s["rel_odometry"][:count])
                        for s in seqs], config)
    t1 = time.perf_counter()
    arrays = [torch.from_numpy(a).to(dev) for a in padded]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state = init_batched_state(config, len(seqs), device=dev)
    ext = torch.tensor(np.asarray(seqs[0]["extrinsic"], np.float32),
                       device=dev)
    runner = make_batched_sequence_runner(config, dev)
    launches = None
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            out = runner(state, *arrays[:4], ext, arrays[4])
            torch.cuda.synchronize()
        launches = sum(e.device_type == DeviceType.CUDA
                       for e in prof.events()) / count
    else:
        out = runner(state, *arrays[:4], ext, arrays[4])
    poses = out[1].cpu().numpy().astype(np.float64)
    overflow = out[2].cpu().numpy()
    t3 = time.perf_counter()
    stages = {"pad_s": t1 - t0, "upload_s": t2 - t1, "run_s": t3 - t2,
              "seconds": t3 - t0}
    return poses, overflow, stages, launches


def batched_drive_phase(torch, np):
    """BATCH distinct headline drives (the last cut short) through the
    batched sequence runner, against each drive's own ``run_offline`` on
    the card.  Returns (row, the drives)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**HEADLINE)
    count = MAIN_FRAMES
    seqs = [synthetic.make_sequence(count, world_seed=s, traj_seed=s + 10,
                                    noise_seed=s + 20,
                                    lidar=synthetic.realistic_lidar(),
                                    clear_path_margin=3.0)
            for s in range(BATCH)]
    last = seqs[-1]
    seqs[-1] = dict(last, frames=last["frames"][:BATCH_SHORT],
                    rel_odometry=last["rel_odometry"][:BATCH_SHORT],
                    gt_poses=last["gt_poses"][:BATCH_SHORT])
    run_batched(torch, np, seqs, cfg, 3)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    gn.LAUNCHES = 0
    gn.FRAMES = 0
    poses, overflow, stages, _ = run_batched(torch, np, seqs, cfg, count)
    seconds = stages["seconds"]
    launches, frames = gn.LAUNCHES, gn.FRAMES
    peak = torch.cuda.max_memory_allocated()

    per_seq = []
    for i, s in enumerate(seqs):
        f_i = len(s["frames"])
        got = poses[:f_i, i]
        single, single_s, single_overflow, _ = run_drive(torch, s, cfg, f_i)
        gt = s["gt_poses"][:f_i]
        ate = ate_rmse(gt, got, align=False)
        ate_dead = ate_rmse(gt, dead_reckoning(np, s["rel_odometry"][:f_i]),
                            align=False)
        per_seq.append({
            "frames": f_i, "ate_vs_gt_m": ate,
            "ate_dead_reckoning_m": ate_dead,
            "beats_dead_reckoning": ate < ate_dead,
            "ate_vs_run_offline_m": ate_rmse(single, got, align=False),
            "frames_bit_equal_to_run_offline": sum(
                bool(np.array_equal(a, b)) for a, b in zip(got, single)),
            "run_offline_frames_per_s": f_i / single_s,
            "run_offline_overflow": single_overflow or [0, 0, 0]})
    padded = poses[BATCH_SHORT:, -1]
    row = {"phase": "batched_drive", "B": BATCH, "frames": count,
           "short_sequence_frames": BATCH_SHORT, "config": HEADLINE,
           "gn_launches": launches, "gn_frames_solved": frames,
           "frames_per_launch": frames / max(launches, 1),
           "overflow": overflow.tolist(), "seconds": seconds,
           "stages_s": stages,
           "aggregate_frames_per_s": BATCH * count / seconds,
           "peak_memory_bytes": peak,
           # a fact of each drive's data, not of the batch: each pose is
           # held to the drive's own run_offline below, and the main path
           # phase holds run_offline to its dead reckoning
           "drives_beating_dead_reckoning": sum(
               p["beats_dead_reckoning"] for p in per_seq),
           "sequences": per_seq}
    row["checks"] = {
        "finite": bool(np.isfinite(poses).all()),
        "one_gn_launch_per_batched_frame": launches == count,
        "b_frames_per_launch": frames == BATCH * count,
        "zero_overflow": not overflow.any() and not any(
            any(p["run_offline_overflow"]) for p in per_seq),
        "each_within_5mm_of_run_offline": all(
            p["ate_vs_run_offline_m"] < 5e-3 for p in per_seq),
        "padding_keeps_the_short_pose": all(
            np.array_equal(p, poses[BATCH_SHORT - 1, -1]) for p in padded)}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"batched_drive failed: {row['checks']}")
    return row, seqs


def batched_sweep_phase(torch, np, seq, card):
    """Aggregate frames/s, device launches a batched frame and peak memory
    at each B of SWEEP_BATCHES (the batch filled with one drive), beside
    the same call's ``run_offline``."""
    from kinematic_icp_tpu_torch import Config

    cfg = Config(**HEADLINE)
    count = SWEEP_FRAMES
    rows = {}
    for b in SWEEP_BATCHES:
        seqs = [seq] * b
        run_batched(torch, np, seqs, cfg, 3)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        _, overflow, stages, _ = run_batched(torch, np, seqs, cfg, count)
        seconds = stages["seconds"]
        peak = torch.cuda.max_memory_allocated()
        _, _, _, launches = run_batched(torch, np, seqs, cfg,
                                        PROFILED_FRAMES, profile=True)
        rows[b] = {"aggregate_frames_per_s": b * count / seconds,
                   "batched_frames_per_s": count / seconds,
                   # a batched frame's wall ms, split by stage
                   **{k[:-2] + "_ms_per_frame": v * 1e3 / count
                      for k, v in stages.items() if k != "seconds"},
                   "launches_per_batched_frame": launches,
                   "peak_memory_bytes": peak,
                   "zero_overflow": not overflow.any()}
    _, single_s, _, _ = run_drive(torch, seq, cfg, count)
    ratio = (rows[BATCH]["launches_per_batched_frame"]
             / rows[1]["launches_per_batched_frame"])
    row = {"phase": "batched_sweep", "frames": count, "nvidia_smi": card,
           "profiled_frames": PROFILED_FRAMES,
           "by_batch": {str(b): r for b, r in rows.items()},
           "run_offline_frames_per_s": count / single_s,
           f"launches_b{BATCH}_over_b1": ratio}
    row["checks"] = {"launches_independent_of_batch": ratio <= 1.1,
                     "zero_overflow": all(r["zero_overflow"]
                                          for r in rows.values())}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"batched_sweep failed: {row['checks']}")
    return row


def gate_between(np, norms):
    """A stationary gate in the widest gap between the middle half of the
    moving frames' |log(rel)|: far from every frame's value, where the
    host's float64 gate and the device's float32 gate agree."""
    s = np.sort(norms[norms > 1e-3])
    lo = len(s) // 4
    hi = max(3 * len(s) // 4, lo + 1)
    i = lo + int(np.argmax(np.diff(s)[lo:hi]))
    return float(0.5 * (s[i] + s[i + 1]))


def batched_runner_phase(torch, np, seqs):
    """``BatchedOdometryRunner`` over RUNNER_FRAMES frames of two drives:
    ``run`` (a host-gated ``step`` a frame) against ``run_device``, a
    stationary gate other than 1e-3 in both, and the raise on too many
    sequences."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.oracle.reference import se3_log
    from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**HEADLINE)
    two = [{"frames": s["frames"][:RUNNER_FRAMES],
            "rel_odometry": s["rel_odometry"][:RUNNER_FRAMES]}
           for s in seqs[:2]]
    ext = seqs[0]["extrinsic"]

    def runner(gate=1e-3, batch=2):
        return BatchedOdometryRunner(cfg, batch, extrinsic=ext,
                                     stationary_gate=gate)

    stepped = runner().run(two)
    device = runner().run_device(two)
    ate = [ate_rmse(stepped[i], device[i], align=False) for i in range(2)]
    norms = np.array([np.linalg.norm(se3_log(np.asarray(r, np.float64)))
                      for r in two[0]["rel_odometry"]])
    gate = gate_between(np, norms)
    gated = {}
    for how in ("run", "run_device"):
        poses = np.asarray(getattr(runner(gate), how)(two)[0])
        prev = np.concatenate([np.eye(4)[None], poses[:-1]])
        gated[how] = (np.abs(poses - prev).max(axis=(1, 2)) > 0).tolist()
    want = (norms > gate).tolist()
    try:
        runner(batch=1).run_device(two)
        raised = False
    except ValueError:
        raised = True
    row = {"phase": "batched_runner", "frames": RUNNER_FRAMES,
           "ate_run_vs_run_device_m": ate, "stationary_gate": gate,
           "active_frames_default_gate": int((norms > 1e-3).sum()),
           "active_frames_gate": int(sum(want)),
           "moved_frames": {k: int(sum(v)) for k, v in gated.items()}}
    row["checks"] = {
        "run_and_run_device_within_5mm": max(ate) < 5e-3,
        "gate_selects_frames_in_both": (gated["run"] == want
                                        == gated["run_device"]),
        "gate_differs_from_1e-3": int(sum(want)) < int((norms > 1e-3).sum()),
        "too_many_sequences_raise": raised}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"batched_runner failed: {row['checks']}")
    return row


def batched_capacity_phase(torch, np, seq):
    """A batch of the card's co-resident CTA count plus one frame (four
    distinct problems, cycled) at the main shape: ceil(B / capacity) = 2
    launches, every frame bit-equal to its own single launch."""
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.ops.hashmap import CandidateSet
    from kinematic_icp_tpu_torch.ops.points import P3

    dev = torch.device("cuda")
    capacity = gn.capacity(dev, False)
    b = capacity + 1
    problems = [gn_problem(torch, np, seq, 10, 1024, False, seed=i)
                for i in range(4)]
    args, kw = stack_frames(torch, problems), problems[0][1]
    pick = torch.arange(b, device=dev) % 4
    cand = CandidateSet(*(t[pick].contiguous() for t in args[0]))
    source = P3(*(t[pick].contiguous() for t in args[1]))
    batch = (cand, source, *(t[pick].contiguous() for t in args[2:]))
    gn.LAUNCHES = 0
    gn.FRAMES = 0
    out = gn.gn_solve(*batch, backend="cuda", **kw)
    torch.cuda.synchronize()
    launched = (gn.LAUNCHES, gn.FRAMES)
    singles = [gn.gn_solve(*p[0], backend="cuda", **kw) for p in problems]
    equal = sum(all(bits_equal(torch, x[i], y)
                    for x, y in zip(out, singles[i % 4])) for i in range(b))
    ms = median_ms(lambda: gn.gn_solve(*batch, backend="cuda", **kw),
                   runs=5, calls=2)
    row = {"phase": "batched_capacity", "capacity": capacity, "B": b,
           "V": 10, "N": 1024, "launches": launched[0],
           "frames_solved": launched[1], "frames_bit_equal": equal,
           "ms": ms, "ms_per_frame": ms / b}
    row["checks"] = {"two_launches": launched == (2, b),
                     "bit_equal_to_single_launches": equal == b}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"batched_capacity failed: {row['checks']}")
    return row


def batched_phase(torch, np, seq, card):
    """The batched multi-sequence path: the kernel on B frames a launch,
    BATCH drives through the batched runner, the B sweep and
    ``BatchedOdometryRunner``; then one summary line."""
    kernels = [batched_kernel_phase(torch, np, seq, 10, n)
               for n in (1024, 8192)]
    drive, seqs = batched_drive_phase(torch, np)
    sweep = batched_sweep_phase(torch, np, seq, card)
    runner = batched_runner_phase(torch, np, seqs)
    capacity = batched_capacity_phase(torch, np, seq)
    row = {"phase": "batched", "B": BATCH,
           "kernel_frames_bit_equal_to_single_launch": {
               str(k["N"]): k["frames_bit_equal_to_single_launch"]
               for k in kernels},
           "gn_launches_per_batched_frame": (drive["gn_launches"]
                                             / drive["frames"]),
           "overflow": drive["overflow"],
           "ate_vs_run_offline_m": [p["ate_vs_run_offline_m"]
                                    for p in drive["sequences"]],
           "frames_bit_equal_to_run_offline": [
               p["frames_bit_equal_to_run_offline"]
               for p in drive["sequences"]],
           "ate_vs_gt_m": [p["ate_vs_gt_m"] for p in drive["sequences"]],
           "ate_dead_reckoning_m": [p["ate_dead_reckoning_m"]
                                    for p in drive["sequences"]],
           "drives_beating_dead_reckoning":
               drive["drives_beating_dead_reckoning"],
           f"launches_b{BATCH}_over_b1": sweep[f"launches_b{BATCH}_over_b1"],
           "aggregate_frames_per_s": {
               b: r["aggregate_frames_per_s"]
               for b, r in sweep["by_batch"].items()},
           "checks": {**{f"kernel_N{k['N']}_" + c: v for k in kernels
                         for c, v in k["checks"].items()},
                      **{"drive_" + c: v for c, v in drive["checks"].items()},
                      **{"sweep_" + c: v for c, v in sweep["checks"].items()},
                      **{"runner_" + c: v
                         for c, v in runner["checks"].items()},
                      **{"capacity_" + c: v
                         for c, v in capacity["checks"].items()}}}
    emit(row)
    return kernels[0], drive


def stamped_poses(np, server):
    return np.asarray([p for _, p in server.poses_with_stamps])


def serve_frames(server, seq, frames, blocking=True):
    """Feed ``frames`` (indices) of the drive to ``server``; returns the
    wall seconds of each ``register_frame`` call that registered its frame
    (a stationary frame is host work only) and of all calls.  A blocking
    call returns after its one readback, so its wall time is the frame's
    latency."""
    registered, total = [], 0.0
    for i in frames:
        pts, ts = seq["frames"][i]
        t0 = time.perf_counter()
        res = server.register_frame(pts, ts, seq["rel_odometry"][i],
                                    stamp=SCAN_PERIOD * (i + 1),
                                    blocking=blocking)
        seconds = time.perf_counter() - t0
        total += seconds
        if res["registered"]:
            registered.append(seconds)
    return registered, total


def pack_and_upload_ms(torch, np, seq, count):
    """Median host ms, per codec, of a served frame's pack (numpy, at the
    headline bucket) and of its upload (one pageable host->device copy,
    synchronized), over the drive's frames."""
    from kinematic_icp_tpu_torch.utils import packing

    bucket = HEADLINE["max_points"]
    pack, upload = {}, {}
    for codec in packing.CODECS:
        times = []
        for i in range(1, count):
            pts, ts = seq["frames"][i]
            t0 = time.perf_counter()
            buf, _ = packing.pack_frame(pts, ts, seq["rel_odometry"][i],
                                        bucket, codec)
            t1 = time.perf_counter()
            torch.from_numpy(buf.view(np.int16)).to("cuda")
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t1))
        pack[codec], upload[codec] = (float(v) * 1e3 for v in
                                      np.median(np.asarray(times), axis=0))
    return pack, upload


def serve_check(row, name):
    row["checks"] = {k: bool(v) for k, v in row["checks"].items()}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"{name} failed: {row['checks']}")


def serve_phase(torch, np, seq, main_poses):
    """The serving path at the headline shape: blocking, streaming "steps"
    and "scan", the u16 codec, checkpoint resume and the online node.
    Each sub-phase sets the GN launch count to 0 just before its run and
    reads it just after.  Returns the blocking run's GN launches."""
    import io

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.online import OnlineOdometryNode
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import checkpoint, synthetic
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**HEADLINE)
    count = MAIN_FRAMES
    ext = seq["extrinsic"]
    gt = seq["gt_poses"][:count]
    zero = {"points_truncated": 0, "downsample_dropped": 0,
            "source_dropped": 0, "insert_failed": 0}

    def server(**kw):
        return LidarOdometryServer(cfg, extrinsic=ext, **kw)

    # 1. blocking, with the checkpoint saved after frame 30 (outside the
    #    timed calls)
    blocking = server()
    t0 = time.perf_counter()
    blocking.warmup(HEADLINE["max_points"])
    warmup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gn.LAUNCHES = 0
    lat, total = serve_frames(blocking, seq, range(SERVE_CHECKPOINT_FRAME))
    launches = gn.LAUNCHES
    ckpt = io.BytesIO()
    checkpoint.save_state(ckpt, blocking.state, cfg)
    gn.LAUNCHES = 0
    lat2, total2 = serve_frames(blocking, seq,
                                range(SERVE_CHECKPOINT_FRAME, count))
    launches += gn.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    poses = stamped_poses(np, blocking)
    registered = blocking.frames_registered
    lat = np.asarray(lat + lat2, np.float64) * 1e3
    pack_ms, upload_ms = pack_and_upload_ms(torch, np, seq, count)
    ate = ate_rmse(gt, poses, align=False)
    ate_dead = ate_rmse(gt, dead_reckoning(np, seq["rel_odometry"][:count]),
                        align=False)
    ate_offline = ate_rmse(main_poses, poses, align=False)
    equal = sum(bool(np.array_equal(a, b)) for a, b in zip(poses, main_poses))
    row = {"phase": "serve_blocking", "frames": count,
           "frames_registered": registered,
           "frames_skipped": blocking.frames_skipped,
           "warmup_s": warmup_s,
           # over the registered frames' register_frame calls
           "latency_ms": {"p50": float(np.percentile(lat, 50)),
                          "p90": float(np.percentile(lat, 90)),
                          "p99": float(np.percentile(lat, 99)),
                          "mean": float(lat.mean()), "max": float(lat.max())},
           # two parts of it, timed apart from the server on the same
           # frames, for both codecs
           "pack_ms_p50": pack_ms, "upload_ms_p50": upload_ms,
           "frames_per_s": count / (total + total2),
           "gn_launches": launches, "overflow": blocking.overflow_stats,
           "peak_memory_bytes": peak, "ate_vs_gt_m": ate,
           "ate_dead_reckoning_m": ate_dead, "ate_vs_offline_m": ate_offline,
           "frames_bit_equal_to_offline": equal,
           "max_abs_diff_vs_offline": float(np.abs(poses - main_poses).max())}
    row["checks"] = {"finite": bool(np.isfinite(poses).all()),
                     "kernel_every_registered_frame": launches == registered,
                     "zero_overflow": blocking.overflow_stats == zero,
                     "beats_dead_reckoning": ate < ate_dead,
                     "offline_within_5mm": ate_offline < 5e-3}
    serve_check(row, "serve_blocking")

    # 2-3. streaming, "steps" then "scan"
    rows = {}
    for mode in ("steps", "scan"):
        s = server(stream_chunk=SERVE_CHUNK, stream_mode=mode)
        gn.LAUNCHES = 0
        t0 = time.perf_counter()
        serve_frames(s, seq, range(count), blocking=False)
        s.drain()
        seconds = time.perf_counter() - t0
        got = stamped_poses(np, s)
        rows[mode] = got
        row = {"phase": f"serve_stream_{mode}", "frames": count,
               "stream_chunk": SERVE_CHUNK, "gn_launches": gn.LAUNCHES,
               "frames_registered": s.frames_registered,
               "frames_per_s": count / seconds, "seconds": seconds,
               "overflow": s.overflow_stats}
        if mode == "steps":
            row["frames_bit_equal_to_blocking"] = sum(
                bool(np.array_equal(a, b)) for a, b in zip(got, poses))
            row["checks"] = {
                "bit_equal_to_blocking": np.array_equal(got, poses),
                "kernel_every_registered_frame":
                    gn.LAUNCHES == s.frames_registered}
        else:
            diff = float(np.abs(got - rows["steps"]).max())
            flushes = -(-s.frames_registered // SERVE_CHUNK)
            row["max_abs_diff_vs_steps"] = diff
            row["checks"] = {
                "within_1e-6_of_steps": diff <= 1e-6,
                # every row of every chunk runs, padding rows included
                "kernel_every_row": gn.LAUNCHES == flushes * SERVE_CHUNK}
        row["checks"]["overflow_equal"] = (
            s.overflow_stats == blocking.overflow_stats)
        serve_check(row, f"serve_stream_{mode}")

    # 4. the u16 upload codec
    quantized = server(upload="u16")
    gn.LAUNCHES = 0
    _, total = serve_frames(quantized, seq, range(count))
    got = stamped_poses(np, quantized)
    ate_u16 = ate_rmse(poses, got, align=False)
    serve_check({"phase": "serve_u16", "frames": count,
                 "gn_launches": gn.LAUNCHES,
                 "frames_per_s": count / total,
                 "ate_vs_f32_server_m": ate_u16,
                 "ate_vs_gt_m": ate_rmse(gt, got, align=False),
                 "overflow": quantized.overflow_stats,
                 "checks": {"ate_vs_f32_below_0.02m": ate_u16 < 0.02,
                            "kernel_every_registered_frame":
                                gn.LAUNCHES == quantized.frames_registered}},
                "serve_u16")

    # 5. checkpoint resume: a fresh server continues from frame 30
    ckpt.seek(0)
    state, meta = checkpoint.load_state(ckpt)
    resumed = server()
    resumed.state = state
    gn.LAUNCHES = 0
    serve_frames(resumed, seq, range(SERVE_CHECKPOINT_FRAME, count))
    got = stamped_poses(np, resumed)
    tail = poses[SERVE_CHECKPOINT_FRAME:]
    serve_check({"phase": "serve_checkpoint", "saved_at_frame":
                 SERVE_CHECKPOINT_FRAME, "checkpoint_bytes": len(
                     ckpt.getvalue()), "gn_launches": gn.LAUNCHES,
                 "frames_bit_equal": sum(bool(np.array_equal(a, b))
                                         for a, b in zip(got, tail)),
                 "checks": {
                     "config_round_trip":
                         checkpoint.load_config(meta) == cfg,
                     "bit_equal_to_uninterrupted":
                         np.array_equal(got, tail)}},
                "serve_checkpoint")

    # 6. the online node over in-memory messages
    n = ONLINE_FRAMES
    sub = dict(seq, frames=seq["frames"][:n],
               rel_odometry=seq["rel_odometry"][:n])
    outputs = []
    node = OnlineOdometryNode(cfg, on_odometry=lambda o, t, r: outputs.append(
        (o, t)))
    gn.LAUNCHES = 0
    t0 = time.perf_counter()
    node.run(synthetic.sequence_messages(sub))
    seconds = time.perf_counter() - t0
    srv = node.server
    odom, tf_msg = outputs[-1]
    online = stamped_poses(np, srv)
    serve_check({"phase": "serve_online", "frames": n,
                 "frames_registered": srv.frames_registered,
                 "frames_skipped": srv.frames_skipped,
                 "callbacks": len(outputs), "gn_launches": gn.LAUNCHES,
                 "frames_per_s": n / seconds,
                 "ate_vs_gt_m": ate_rmse(gt[:n], online, align=False),
                 "checks": {
                     "callback_every_frame": len(outputs) == (
                         srv.frames_registered + srv.frames_skipped) == n,
                     "finite": bool(np.isfinite(online).all()) and bool(
                         np.isfinite(odom.position).all()),
                     "frame_ids": (odom.header.frame_id == "odom_lidar"
                                   and tf_msg.transforms[0].header.frame_id
                                   == "base_link"
                                   and odom.pose_covariance[0] == 0.1),
                     "kernel_every_registered_frame":
                         gn.LAUNCHES == srv.frames_registered}},
                "serve_online")

    # 7. a float64 state: the kernel solves its frames in float32, as its
    #    plain version does, and the poses come back in float64
    n = FLOAT64_FRAMES
    wide = server(dtype=torch.float64)
    gn.LAUNCHES = 0
    _, total = serve_frames(wide, seq, range(n))
    got = stamped_poses(np, wide)
    ate64 = ate_rmse(poses[:n], got, align=False)
    serve_check({"phase": "serve_float64", "frames": n,
                 "frames_registered": wide.frames_registered,
                 "gn_launches": gn.LAUNCHES, "frames_per_s": n / total,
                 "ate_vs_f32_server_m": ate64,
                 "checks": {
                     "float64_state": wide.state.pose.dtype == torch.float64,
                     "finite": bool(np.isfinite(got).all()),
                     "registered_every_active_frame":
                         wide.frames_registered == n - 1,
                     "kernel_every_registered_frame":
                         gn.LAUNCHES == wide.frames_registered,
                     "within_5mm_of_f32": ate64 < 5e-3}},
                "serve_float64")
    return launches


def cli_drive(np, bag, out_dir, argv):
    """``run_odometry.main`` over ``bag`` on the card, with the GN launch
    count set to 0 just before and read just after.  Returns (TUM path,
    stamps, poses, the CLI's timings, GN launches, wall seconds)."""
    from kinematic_icp_tpu_torch import run_odometry
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils.io.tum import read_tum

    timings = {}
    gn.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_odometry.main([bag, "--no-progress", "--output-dir", out_dir,
                             *argv], timings=timings)
    seconds = time.perf_counter() - t0
    launches = gn.LAUNCHES
    stamps, poses = read_tum(out)
    return out, np.asarray(stamps), np.asarray(poses), timings, launches, \
        seconds


def cli_checks(np, seq, poses, timings, launches, count):
    """The checks both CLI drives share, and the ATEs they rest on."""
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse
    from kinematic_icp_tpu_torch.utils.io import native

    gt = seq["gt_poses"][:count]
    ate = ate_rmse(gt, poses, align=False)
    ate_dead = ate_rmse(gt, dead_reckoning(np, seq["rel_odometry"][:count]),
                        align=False)
    checks = {"tum_row_every_frame": len(poses) == timings["frames"] == count,
              "finite": bool(np.isfinite(poses).all()),
              "kernel_every_registered_frame":
                  launches == timings["registered"] == count - 1,
              "native_library_loaded": native.get_lib() is not None,
              "beats_dead_reckoning": ate < ate_dead}
    return checks, ate, ate_dead


def cli_phase(torch, np, seq, main_poses, card):
    """The offline CLI on the card: the headline drive as a bag, then its
    LaserScan topic.  Returns the 3D drive's GN launches."""
    import os
    import tempfile

    from kinematic_icp_tpu_torch import Config, evaluate
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse
    from kinematic_icp_tpu_torch.utils.io.tum import write_tum

    count = MAIN_FRAMES
    with tempfile.TemporaryDirectory(prefix="kicp_cli_") as tmp:
        bag = os.path.join(tmp, "headline.mcap")
        t0 = time.perf_counter()
        synthetic.write_sequence_to_mcap(seq, bag)
        write_s = time.perf_counter() - t0
        argv = ["--max-points", str(HEADLINE["max_points"]), "--visualize"]
        try:
            import yaml
        except ImportError:
            yaml = None
        if yaml is not None:
            params = os.path.join(tmp, "params.yaml")
            with open(params, "w") as f:
                yaml.safe_dump({"kinematic_icp_offline_node": {
                    "ros__parameters": HEADLINE}}, f)
            argv += ["--config", params]
            reference = main_poses
        else:
            # the CLI's own default configuration, held to run_offline's
            # drive under the same configuration
            reference, _, _, _ = run_drive(
                torch, seq, Config(deskew=True,
                                   max_points=HEADLINE["max_points"]), count)
        out, stamps, poses, timings, launches, seconds = cli_drive(
            np, bag, tmp, argv)
        checks, ate, ate_dead = cli_checks(np, seq, poses, timings, launches,
                                           count)
        ate_offline = ate_rmse(reference, poses, align=False)
        checks["run_offline_within_floor"] = ate_offline < FLOOR_M
        checks["viewer_written"] = os.path.exists(os.path.join(
            tmp, "headline_kinematic_icp_view.html"))
        gt_tum = os.path.join(tmp, "gt.txt")
        write_tum(gt_tum, list(zip(stamps, seq["gt_poses"][:count])))
        scores = evaluate.evaluate_files(out, gt_tum, align=False)
        row = {"phase": "cli", "frames": count, "nvidia_smi": card,
               "config": "yaml: headline" if yaml is not None
               else "default Config(deskew=True)",
               "bag_bytes": os.path.getsize(bag), "bag_write_s": write_s,
               "frames_registered": timings["registered"],
               "gn_launches": launches, "seconds": seconds,
               "frames_per_s": count / seconds,
               "wall_s": {k: timings[k] for k in
                          ("read_s", "register_s", "write_s")},
               "ms_per_frame": {k[:-2]: timings[k] * 1e3 / count for k in
                                ("read_s", "register_s", "write_s")},
               "ate_vs_gt_m": ate, "ate_dead_reckoning_m": ate_dead,
               "ate_vs_run_offline_m": ate_offline,
               "evaluate_vs_gt": scores, "checks": checks}
        serve_check(row, "cli")

        # the 2D LaserScan topic of the first frames of the same world
        n = CLI_2D_FRAMES
        sub = dict(seq, frames=seq["frames"][:n],
                   rel_odometry=seq["rel_odometry"][:n],
                   gt_poses=seq["gt_poses"][:n])
        bag2d = os.path.join(tmp, "planar.mcap")
        synthetic.write_sequence_to_mcap(sub, bag2d,
                                         scan_2d_topic=SCAN_2D_TOPIC)
        _, _, poses2d, timings2d, launches2d, seconds2d = cli_drive(
            np, bag2d, tmp, ["--use-2d-lidar", "--lidar-topic",
                             SCAN_2D_TOPIC, "--max-points",
                             str(CLI_2D_MAX_POINTS)])
        checks2d, ate2d, dead2d = cli_checks(np, sub, poses2d, timings2d,
                                             launches2d, n)
        serve_check({"phase": "cli_2d", "frames": n,
                     "frames_registered": timings2d["registered"],
                     "gn_launches": launches2d,
                     "frames_per_s": n / seconds2d,
                     "ms_per_frame": {k[:-2]: timings2d[k] * 1e3 / n for k in
                                      ("read_s", "register_s", "write_s")},
                     "ate_vs_gt_m": ate2d, "ate_dead_reckoning_m": dead2d,
                     "checks": checks2d}, "cli_2d")
    return launches


def oracle_phase(torch, np, seq, main_poses):
    """The card's drive held to the two differential oracles: the port's
    float64 ``OracleKinematicICP`` over tests/test_differential.py's drive
    and bounds, and the native C++ baseline over the headline frames."""
    from kinematic_icp_tpu_torch import Config, baseline_native
    from kinematic_icp_tpu_torch.oracle import OracleKinematicICP
    from kinematic_icp_tpu_torch.oracle.reference import se3_log
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    small = synthetic.make_sequence(DIFF_FRAMES)
    cfg = Config(**DIFF)
    card_poses, _, _, _ = run_drive(torch, small, cfg, DIFF_FRAMES)
    oracle = OracleKinematicICP(cfg)
    oracle_poses = []
    t0 = time.perf_counter()
    for (pts, ts), rel in zip(small["frames"], small["rel_odometry"]):
        # behind the server's stationary gate, as the card's runner
        if np.linalg.norm(se3_log(rel)) > 1e-3:
            oracle.register_frame(pts.astype(np.float64),
                                  ts.astype(np.float64), small["extrinsic"],
                                  rel)
        oracle_poses.append(oracle.last_pose.copy())
    oracle_s = time.perf_counter() - t0
    gt = small["gt_poses"]
    dead = ate_rmse(gt, dead_reckoning(np, small["rel_odometry"]),
                    align=False)
    ate = ate_rmse(oracle_poses, card_poses, align=False)
    per_frame = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
                 for a, b in zip(oracle_poses, card_poses)]
    ate_oracle_gt = ate_rmse(gt, oracle_poses, align=False)
    ate_card_gt = ate_rmse(gt, card_poses, align=False)

    count = MAIN_FRAMES
    frames, rels = seq["frames"][:count], seq["rel_odometry"][:count]
    t0 = time.perf_counter()
    base, stats = baseline_native.run_baseline(Config(**HEADLINE), frames,
                                               rels, seq["extrinsic"])
    baseline_s = time.perf_counter() - t0
    base_vs_card = ate_rmse(base, main_poses, align=False)
    floors = chaos_floors(np, seq, base, count)
    # tests/test_differential.py:137: within the larger of 0.05 m and 3.5
    # times this drive's own self-divergence
    bound = max(0.05, 3.5 * max(floors))
    row = {"phase": "oracle", "frames": DIFF_FRAMES, "config": DIFF,
           "oracle_seconds": oracle_s,
           "ate_card_vs_oracle_m": ate,
           "max_frame_divergence_m": max(per_frame),
           "ate_oracle_vs_gt_m": ate_oracle_gt,
           "ate_card_vs_gt_m": ate_card_gt, "ate_dead_reckoning_m": dead,
           "baseline": {"frames": count, "config": HEADLINE,
                        "seconds": baseline_s, "threads": stats["threads"],
                        "frames_per_s": stats["fps"],
                        "ate_vs_card_run_offline_m": base_vs_card,
                        "self_divergence_m": floors,
                        "bound_m": bound,
                        "headline_floor_m": FLOOR_M,
                        "ate_vs_gt_m": ate_rmse(seq["gt_poses"][:count], base,
                                                align=False)}}
    row["checks"] = {"card_within_ate_of_oracle": ate < DIFF_ATE_M,
                     "every_frame_within_bound": max(per_frame)
                     < DIFF_FRAME_M,
                     "oracle_beats_dead_reckoning": ate_oracle_gt < dead,
                     "card_beats_dead_reckoning": ate_card_gt < dead,
                     "baseline_finite": bool(np.isfinite(base).all()),
                     "baseline_within_self_divergence_bound":
                         base_vs_card <= bound}
    serve_check(row, "oracle")


def chaos_floors(np, seq, exact, count):
    """The baseline's own divergence on this drive (tests/test_differential
    .py:91-115): its ATE against itself on the same frames with 1 um of
    noise, and on two permutations of each frame's points."""
    from kinematic_icp_tpu_torch import Config, baseline_native
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    frames, rels = seq["frames"][:count], seq["rel_odometry"][:count]
    rng = np.random.default_rng(7)
    draws = [[(p + rng.normal(0, 1e-6, p.shape), t) for p, t in frames]]
    for d in range(2):
        rng = np.random.default_rng(777 + d)
        perms = [rng.permutation(len(p)) for p, _ in frames]
        draws.append([(p[i], t[i]) for (p, t), i in zip(frames, perms)])
    return [ate_rmse(list(exact), list(baseline_native.run_baseline(
        Config(**HEADLINE), d, rels, seq["extrinsic"])[0]), align=False)
        for d in draws]


def spills(log):
    """Spill bytes (stores + loads) in each ptxas line of an nvcc log."""
    return [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from kinematic_icp_tpu_torch.ops import cuda_build
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.io import native

    card = nvidia_smi_line()
    emit({"phase": "environment", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # the host C++ (the ingestion library, the baseline) builds beside nvcc
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build, "kicp_io", "kicp_baseline")
        built = cuda_build.build("gn_solve")
        host_built = host.result()
    emit({"phase": "build_host", "targets": {
        name: {"seconds": b["seconds"], "path": b["path"]}
        for name, b in host_built.items()}})
    # one template instance per check_crossing value, each with a line
    spill = {name: spills(b["log"]) for name, b in built.items()}
    emit({"phase": "build", "kernels": {
        name: {"seconds": b["seconds"], "spill_bytes": spill[name],
               "ptxas": [ln.strip() for ln in b["log"].splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, b in built.items()}})
    if any(len(v) < 2 or any(v) for v in spill.values()):
        raise SystemExit(f"ptxas reports spills (or no spill lines): {spill}")

    seq = synthetic.make_sequence(MAIN_FRAMES,
                                  lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    main_shape = kernel_phase(torch, np, seq, 10, 1024, False)
    kernel_phase(torch, np, seq, 10, 8192, False)
    kernel_phase(torch, np, seq, 27, 1024, True)

    main_row, main_poses = drive_phase(torch, np, seq, "main_path",
                                       HEADLINE, MAIN_FRAMES, True)
    drive_phase(torch, np, seq, "stock_config", STOCK, STOCK_FRAMES, False)
    exact_launches = exact_phase(torch, np, seq, main_poses)
    fallback_phase(torch, np)
    pruned_phase(torch, np, seq)
    batched_kernel, batched_drive = batched_phase(torch, np, seq, card)
    serve_launches = serve_phase(torch, np, seq, main_poses)
    cli_launches = cli_phase(torch, np, seq, main_poses, card)
    oracle_phase(torch, np, seq, main_poses)

    emit({"kernels": [{
        "name": "gn_solve", "route": "cuda",
        "source": "kinematic_icp_tpu_torch/csrc/gn_solve.cu",
        "replaces": "kinematic_icp_tpu/ops/pallas_gn.py:86",
        "launches": main_row["gn_launches"],
        "launches_exact_mode_check_crossing": exact_launches,
        "launches_serve_blocking": serve_launches,
        "launches_cli": cli_launches,
        "launches_batched": batched_drive["gn_launches"],
        "frames_per_launch_batched": batched_drive["frames_per_launch"],
        "batched_ms": batched_kernel["ms"],
        "batched_bound_ms": batched_kernel["bound_ms"],
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
