"""Run the PyTorch/CUDA port on one NVIDIA card and hold it to its checks.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero before the
last line.  Phases:

  1. environment: the card, torch and CUDA versions;
  2. build: every kernel of the main path, compiled from ``csrc/`` by nvcc
     (``gn_solve.cu``, and ``graph_if.cu``, which builds the captured
     frames' conditional nodes); fails if ptxas reports any spill;
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
 10. batched_exact: 4 of those drives, 20 frames, under the exact
     configuration through the batched runner (one ``check_crossing``
     launch a batched frame, the full-27 loop on the batched frames where
     some row's certificate failed, zero overflow, each drive within 5 mm
     of its own ``run_offline``, fallback counts beside that drive's own,
     aggregate frames/s; the full-27 association kernel's launches, one
     an association of the fallback, counted on the device); 2 drives, 10
     frames, pruned exact, bit-equal to the batched full-27 loop;
 10a. nn27: the full-27 association kernel (``csrc/nn27.cu``) on one
     real fallback association of the 8 drives as one batch at the exact
     offline cell's sizes (N = 8,192 source slots): bit-equal to its plain
     version on the live queries, in float32 and float64, one launch a
     call; ms of both, the plain version's peak memory, and the bound
     (the distinct bucket rows the live queries probe, read once);
 10b. peer_reduce: the map axis's all-reduce over peer memory
     (``csrc/peer_reduce.cu``, what a map group on NCCL reduces with, so
     that the GN loop's conditional nodes can hold it): 1, 2 and 4 ranks
     of a peer group on this card, each launching on a stream of its own,
     at the sharded path's shapes (the normal equations' float32 sums, the
     packed keys' int32 minima, the correspondence counts' int32 sums, a
     float64 state's sums), a stock batch's packed keys (8 stock-``Config``
     sequences, 65,536 keys) and beyond a slot (the packed keys of 400:
     3 slots and a remainder, a launch a slot), eagerly and as captured
     graphs, bit-equal to the plain version, and inside an IF node at two
     ranks; ms of the kernel and of the plain version at 1, 2 and 4 ranks,
     and the bound (HBM bytes);
 11. sharded_1rank: a one-rank NCCL group and a (1, 1) mesh,
     ``parallel.BatchedOdometryRunner(mesh=...)`` over 2 of the drives, 20
     frames (``run`` within 1e-5 of ``run_device``, bit-equal to the
     unsharded runner's loop lowering, each drive within 5 mm of its
     ``run_offline``, the frame captured with its collectives, no GN
     launch: the sharded path runs none, by design; ms a frame, and the
     collectives a frame outside the GN loop, a host count; a map group
     of one rank reduces nothing, so the frame launches no peer kernel:
     route "none"); then the same drives on the "nccl" route
     (``make_mesh(map_reduce="nccl")``: NCCL's all-reduce over the one
     rank inside the frame's graph, no IF node, every GN trip run):
     bit-equal to the first row, NCCL's collectives counted (host and
     device), ms a frame and frames/s;
 11b. loop_batch: the unsharded ``parallel.BatchedOdometryRunner`` on the
     GN loop lowering (``gn_backend="torch"``, what the sharded path, pruned
     exact and the certified fallback run) over 4 of the drives, 20
     frames, at B = 4 and each drive alone at B = 1: every frame bit-equal
     (the loop's float sums are ``points.row_sum``'s fixed tree), zero
     overflow;
 12. sharded_2rank: this script again as two worker processes on the one
     card (``--sharded-worker RANK PORT DIR``; gloo, a (1, 2) mesh, a wall
     limit each): gloo's CUDA int32 MIN and float32 SUM; the peer kernel
     across the two processes (``peer.attach`` maps each other's region
     with CUDA IPC over the gloo group; every reduction of ``peer_shapes``
     bit-equal to the plain version; unmapped, then freed); each drive within
     5 mm of the one-rank run, zero overflow, every stored voxel on its
     owner's rank, the frame run eagerly (gloo's collectives cannot be
     captured), each shard's voxel count, ms a frame; then the same drives
     with the map axis on the peer kernel (``map_reduce="peer"``, the peer
     kernel's main path: its launches counted around that run), bit-equal
     to gloo's route;
 13. serve: ``server.LidarOdometryServer`` over the 60 headline frames,
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
 13b. graph: the headline drive (60 frames), the stock ``Config`` drive
     (20), the batched drive of the 8 headline drives, the served
     headline (blocking and ``"scan"``), the certified exact drive (60),
     pruned exact (20), the certified exact batch of 4 drives (20), the
     served certified headline (60) and the sharded runner on a one-rank
     NCCL group (2 drives, 20; on the "none" route and on the "nccl"
     route, whose frame holds no IF node and whose replay runs every GN
     trip), each on the eager loop (``eager=True``)
     and on its CUDA graphs in one call: every frame bit-equal, the same
     GN, ``check_crossing`` and collective counts and fallback frames,
     frames/s, host calls and syncs a frame (none in an offline frame
     loop) and the device's idle share over 20 frames under
     ``torch.profiler``, the capture's ms, one graph a static call and the
     graph pool's bytes; on the paths that run the GN loop (the exact ones
     and the sharded one) the frames again with the loop's work counted on
     the device: the same loops on the same frames, eager running every
     trip, the replay re-associating only as JAX's ``while_loop`` does
     (the sharded loop too: its trips' SUMs and its associations' MINs,
     counted on the device, as many as JAX's trips make, where eager
     issues every trip's), and a ``graph_reassociations`` line of
     re-associations against iterations a loop;
 14. cli: ``run_odometry.main`` (the offline CLI) over the 60 headline
     frames written to an uncompressed mcap by the port's writer (one GN
     launch per registered frame, the native ingestion library loaded,
     better than dead reckoning, within the 0.0251 m self-divergence floor
     of ``run_offline``'s poses, ``evaluate`` against a ground-truth TUM,
     frames/s and the wall split into read/decode, register and write),
     then 20 frames of the 2D LaserScan topic through ``--use-2d-lidar``;
 15. oracle: ``run_offline`` on the card against the port's float64
     ``OracleKinematicICP`` over tests/test_differential.py's drive and
     bounds, and the native C++ baseline (built here from
     ``native/kicp_baseline.cpp``) over the 60 headline frames, within
     tests/test_differential.py:137's bound of this drive's own
     self-divergence (the baseline against itself with 1 um of noise and
     on two permutations of the points);
 16. the ``kernels`` summary line (``gn_solve``; ``peer_reduce``, its
     launches from the two-rank peer-route drive, its ms, plain ms and
     bound by shape and ranks; ``graph_if``, the IF nodes the graph phase
     captured), the card's name and power limit, and the final
     ``{"ok": true, ...}`` line.

Every entry point on the card runs its frames as replays of CUDA graphs
(``pipeline.Step``, ``utils.cuda_graph``): one a frame, under every
registration and the sharded path on NCCL, with no host sync; the exact
modes' full-27 fallback and the GN loop's early exit are conditional
nodes inside it.  Only ``eager=True`` and the gloo ranks run op by op.
Each drive's line says which (``"path"``, read from the static calls the
path ran).

It imports nothing of JAX; it needs one card and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import warnings

#: the card's peak rates for the bound (H100 SXM data sheet, dense), and
#: NVLink's rate each way between two cards of a host
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
NVLINK_BYTES_PER_S = 450e9

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
#: the graph phase: frames a path profiled (eager and captured)
GRAPH_PROFILED_FRAMES = 20
#: the batched exact phase: distinct headline drives and their frames
#: under EXACT, then the pruned drives and frames
EXACT_BATCH = 4
EXACT_BATCH_FRAMES = 20
PRUNED_BATCH = 2
PRUNED_BATCH_FRAMES = 10
#: the nn27 phase: the exact offline cell's sizes (icp_bench/configs/
#: ros_exact.json: 8,192 source slots, a 2**18-voxel map) on the batched
#: phase's BATCH drives, and the frames searched for a fallback
NN27_CONFIG = dict(EXACT, max_downsampled=16384, max_source=8192,
                   map_capacity=1 << 18)
NN27_FRAMES = 20
#: the sharded phases: headline drives and frames, and each two-rank
#: worker's wall limit (s)
SHARD_BATCH = 2
SHARD_FRAMES = 20
SHARD_WORKER_TIMEOUT_S = 300
#: a data rank's sequences whose packed keys (``Config().max_source`` =
#: 8,192 queries each) the peer kernel reduces: a stock batch of 8 (65,536
#: keys, 256 KiB), and 400, which span 3 slots and a remainder
#: (``parallel.peer.SLOT_BYTES``: 1,048,576 int32 keys)
STOCK_SEQUENCES = 8
BEYOND_SLOT_SEQUENCES = 400
#: the loop lowering's batch check: drives at once, and their frames
LOOP_BATCH = 4
LOOP_BATCH_FRAMES = 20
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


#: the CUDA sources the paths run (``csrc/<name>.cu``, one nvcc each, all
#: started together), each with its kernels' ptxas lines: gn_solve one
#: template instance per check_crossing value; graph_if the kernel that
#: sets a captured IF node's handle at each replay (graph machinery, not a
#: port of a TPU kernel); peer_reduce the map axis's all-reduce over peer
#: memory on NCCL meshes, one instance per reduction (float32, float64 and
#: int32 sums, int32 minimum; it stands for JAX's psum and pmin, not a TPU
#: kernel); nn27 the exact modes' full-27 association, one instance per
#: query type (float32, float64; XLA's gathers in JAX, not a TPU kernel)
KERNEL_SOURCES = {"gn_solve": 2, "graph_if": 1, "peer_reduce": 4, "nn27": 2}

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
           "path": path_of(runner_calls(torch, cfg)),
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
          "path": path_of(runner_calls(torch, cfg)),
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
    launches a frame with ``profile``, else None, exact-mode fallback
    frames (B,))."""
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
    return poses, overflow, stages, launches, out[3].cpu().numpy()


def headline_drive(s):
    """Distinct headline drive ``s`` (MAIN_FRAMES frames)."""
    from kinematic_icp_tpu_torch.utils import synthetic

    return synthetic.make_sequence(MAIN_FRAMES, world_seed=s,
                                   traj_seed=s + 10, noise_seed=s + 20,
                                   lidar=synthetic.realistic_lidar(),
                                   clear_path_margin=3.0)


def batched_drive_phase(torch, np):
    """BATCH distinct headline drives (the last cut short) through the
    batched sequence runner, against each drive's own ``run_offline`` on
    the card.  Returns (row, the drives)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**HEADLINE)
    count = MAIN_FRAMES
    seqs = [headline_drive(s) for s in range(BATCH)]
    last = seqs[-1]
    seqs[-1] = dict(last, frames=last["frames"][:BATCH_SHORT],
                    rel_odometry=last["rel_odometry"][:BATCH_SHORT],
                    gt_poses=last["gt_poses"][:BATCH_SHORT])
    run_batched(torch, np, seqs, cfg, 3)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    gn.LAUNCHES = 0
    gn.FRAMES = 0
    poses, overflow, stages, _, _ = run_batched(torch, np, seqs, cfg, count)
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
           "path": path_of(runner_calls(torch, cfg, batched=True)),
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
        _, overflow, stages, _, _ = run_batched(torch, np, seqs, cfg, count)
        seconds = stages["seconds"]
        peak = torch.cuda.max_memory_allocated()
        _, _, _, launches, _ = run_batched(torch, np, seqs, cfg,
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
           "path": path_of(runner_calls(torch, cfg, batched=True)),
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
    return kernels[0], drive, seqs


def batched_exact_phase(torch, np, seqs):
    """EXACT_BATCH distinct headline drives under the reference-exact
    configuration through the batched sequence runner: one launch of the
    kernel's ``check_crossing`` instance a batched frame, and the full-27
    loop on the batched frames where some row's certificate failed; each
    drive against its own ``run_offline``.  Then PRUNED_BATCH drives in
    pruned exact, bit-equal to the batched full-27 loop.  The counts
    (``nn27.LAUNCHES`` among them) are set to 0 just before the batched run
    and read just after; the full-27 loops it ran, their associations and
    the association kernel's launches are counted on the device in a
    second run of the same frames (``counted_run``): every association of
    the certified fallback is one launch of ``csrc/nn27.cu``."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import make_batched_sequence_runner
    from kinematic_icp_tpu_torch.ops import gn, nn27
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(**EXACT)
    count = EXACT_BATCH_FRAMES
    drives = seqs[:EXACT_BATCH]
    run_batched(torch, np, drives, cfg, 3)  # warm-up
    gn.LAUNCHES = 0
    gn.CROSSING_LAUNCHES = 0
    nn27.LAUNCHES = 0
    poses, overflow, stages, _, fallbacks = run_batched(torch, np, drives,
                                                        cfg, count)
    launches, crossing = gn.LAUNCHES, gn.CROSSING_LAUNCHES
    nn27_host = nn27.LAUNCHES
    path = path_of(runner_calls(torch, cfg, batched=True))
    loops = counted_run(
        torch, make_batched_sequence_runner(cfg, torch.device("cuda"))
        .step.release, lambda: run_batched(torch, np, drives, cfg, count),
        lambda: run_batched(torch, np, drives, cfg, 3))
    per_seq = []
    for i, s in enumerate(drives):
        single, single_s, single_overflow, stats = run_drive(torch, s, cfg,
                                                             count)
        got = poses[:, i]
        per_seq.append({
            "ate_vs_run_offline_m": ate_rmse(single, got, align=False),
            "frames_bit_equal_to_run_offline": sum(
                bool(np.array_equal(a, b)) for a, b in zip(got, single)),
            "exact_fallback_frames": int(fallbacks[i]),
            "run_offline_exact_fallback_frames":
                stats["exact_fallback_frames"],
            "run_offline_frames_per_s": count / single_s,
            "run_offline_overflow": single_overflow or [0, 0, 0]})

    pcfg = Config(**PRUNED)
    two = drives[:PRUNED_BATCH]
    pruned, p_overflow, p_stages, _, p_fallbacks = run_batched(
        torch, np, two, pcfg, PRUNED_BATCH_FRAMES)
    full, f_overflow, f_stages, _, _ = run_batched(
        torch, np, two, pcfg.replace(exact_prune_candidates=0),
        PRUNED_BATCH_FRAMES)
    equal = sum(bool(np.array_equal(a, b)) for a, b in zip(pruned, full))
    seconds = stages["seconds"]
    row = {"phase": "batched_exact", "B": EXACT_BATCH, "frames": count,
           "path": path,
           "config": EXACT, "gn_launches": launches,
           "gn_check_crossing_launches": crossing,
           "loop_counts": loops,
           # issued or captured on the host in the batched run (its replays
           # add none), and run by the replays (counted on the device)
           "nn27_host_launches": nn27_host,
           "nn27_launches": loops["nn27_launches"],
           "exact_fallback_frames": fallbacks.tolist(),
           "overflow": overflow.tolist(), "seconds": seconds,
           "stages_s": stages,
           "aggregate_frames_per_s": EXACT_BATCH * count / seconds,
           "sequences": per_seq,
           "pruned": {"B": PRUNED_BATCH, "frames": PRUNED_BATCH_FRAMES,
                      "config": PRUNED,
                      "exact_fallback_frames": p_fallbacks.tolist(),
                      "batched_frames_bit_equal_to_full_27": equal,
                      "aggregate_frames_per_s": PRUNED_BATCH
                      * PRUNED_BATCH_FRAMES / p_stages["seconds"],
                      "full_27_aggregate_frames_per_s": PRUNED_BATCH
                      * PRUNED_BATCH_FRAMES / f_stages["seconds"]}}
    row["checks"] = {
        "finite": bool(np.isfinite(poses).all()),
        "one_check_crossing_launch_per_batched_frame":
            crossing == launches == count,
        # the loop runs on exactly the batched frames where some row
        # crossed (stationary frames included, which the counts leave out)
        "fallback_loop_where_a_row_fell_back": (
            loops["gn_loops"] == loops["fallback_registrations"] <= count
            and (loops["gn_loops"] > 0 or not fallbacks.any())),
        "nn27_on_every_association": (
            loops["nn27_launches"] == loops["associations"]
            and (loops["associations"] > 0 or not fallbacks.any())),
        "zero_overflow": not overflow.any() and not any(
            any(p["run_offline_overflow"]) for p in per_seq),
        "each_within_5mm_of_run_offline": all(
            p["ate_vs_run_offline_m"] < 5e-3 for p in per_seq),
        "pruned_bit_equal_to_full_27": equal == PRUNED_BATCH_FRAMES,
        "pruned_zero_overflow": not p_overflow.any() and not f_overflow.any()}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"batched_exact failed: {row['checks']}")
    return row


def fallback_association(torch, np, drives, config, frames):
    """The inputs of a real full-27 association: the ``drives`` as one
    batch under ``config``, registered frame by frame (``register_frame``)
    until a frame past the first two sets some row's fallback flag; the
    fallback loop's first association of that frame is at the guess, so
    its inputs are the map before the frame, the frame's sources moved by
    the guess, and their mask.  Returns (frame, map, queries, mask, the
    rows that fell back), or None where no frame of the first ``frames``
    fell back."""
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import init_batched_state, pad_batch
    from kinematic_icp_tpu_torch.ops import se3
    from kinematic_icp_tpu_torch.ops.points import transform

    dev = torch.device("cuda")
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a).to(dev) for a in
                                   pad_batch([dict(
                                       s, frames=s["frames"][:frames],
                                       rel_odometry=s["rel_odometry"][:frames])
                                       for s in drives], config))
    ext = torch.tensor(np.asarray(drives[0]["extrinsic"], np.float32),
                       device=dev)
    state = init_batched_state(config, len(drives), device=dev)
    for f in range(frames):
        before = pipeline.clone_state(state)
        state, out = pipeline.register_frame(state, pts[f], ts[f], mask[f],
                                             has_ts[f], ext, rels[f], config)
        fell = out.debug.exact_fallback
        if f >= 2 and bool(fell.any()):
            guess = se3.compose44(before.pose, rels[f])
            return (f, before.map, transform(guess, out.source),
                    out.source_mask, fell.nonzero().flatten().tolist())
    return None


def nn27_bound(torch, m, q, qmask, voxel_size, probes):
    """(bound_ms, bound_by, bytes, flops, rows) of one full-27 association:
    the distinct (sequence, bucket) rows the live queries probe, read once
    (G (K + 4) int32 each), every query's coordinates and mask read and its
    four outputs written once; ~17 float ops (unpack 9, distance 8) for
    each stored point in a live query's 27 voxels."""
    from kinematic_icp_tpu_torch.ops import hashmap
    from kinematic_icp_tpu_torch.ops.voxel import voxel_coords_planar

    b, n = qmask.shape
    nb, g, k = m.num_buckets, m.bucket_slots, m.block_size
    ids = torch.arange(27, device=qmask.device)[:, None]
    ox, oy, oz = hashmap._rel_to_offsets(ids)
    cx, cy, cz = voxel_coords_planar(q, voxel_size)
    bucket = hashmap.bucket_of(cx[:, None] + ox, cy[:, None] + oy,
                               cz[:, None] + oz, nb).to(torch.int64)
    lane = torch.arange(b, device=qmask.device)[:, None, None]
    probed = (lane * nb + bucket)[qmask[:, None, :].expand(-1, 27, -1)]
    rows = int(torch.unique(probed).numel())
    item = q.x.element_size()
    nbytes = rows * g * (k + 4) * 4 + b * n * (3 * item + 1) + 4 * item * b * n
    cand = hashmap.gather_candidates(m, q, voxel_size, probes, 27)
    stored = int(((cand.words != hashmap.PACKED_SENTINEL)
                  & qmask[:, None, None, :]).sum())
    flops = 17 * stored
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops, rows)


def nn27_phase(torch, np, drives):
    """``csrc/nn27.cu`` on one real fallback association of the batched
    exact drive at the exact offline cell's sizes (NN27_CONFIG: B = 8
    drives, N = 8,192 source slots): the inputs of the first full-27
    association of the first batched frame past the second that falls
    back (``fallback_association``); the kernel against its plain version
    (``hashmap.gather_candidates`` at V = 27, then ``nn_from_candidates``),
    (nearest, dist) bit for bit on the live queries and dist inf on the
    others, in float32 and with the queries in float64; one launch a call
    (``nn27.LAUNCHES``); ms of both (CUDA events), the plain version's
    device memory at its peak, and the bound (``nn27_bound``)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import hashmap, nn27

    cfg = Config(**NN27_CONFIG)
    found = fallback_association(torch, np, drives[:BATCH], cfg, NN27_FRAMES)
    if found is None:
        raise SystemExit(f"nn27: no fallback in {NN27_FRAMES} frames")
    frame, m, q, qmask, fell = found
    vs, probes = cfg.voxel_size, cfg.max_probes

    def plain(q=q):
        cand = hashmap.gather_candidates(m, q, vs, probes, 27)
        return hashmap.nn_from_candidates(cand, q, qmask, vs)

    def kernel(q=q):
        return nn27.nearest_neighbor(m, q, qmask, vs)

    def compare(q):
        """(bit-equal on live, dist inf on dead, max |kernel - plain| on
        live) of one call each."""
        before = nn27.LAUNCHES
        (kn, kd), (pn, pd) = hashmap.nearest_neighbor(
            m, q, qmask, vs, probes), plain(q)
        torch.cuda.synchronize()
        launched = nn27.LAUNCHES - before
        pairs = list(zip((*kn, kd), (*pn, pd)))
        same = all(bits_equal(torch, a[qmask], b[qmask]) for a, b in pairs)
        err = max(float((a[qmask] - b[qmask]).abs().nan_to_num(
            posinf=0.0).max()) if qmask.any() else 0.0 for a, b in pairs)
        return same, bool(torch.isinf(kd[~qmask]).all()), err, launched

    same, dead_inf, err, launched = compare(q)
    q64 = q.astype(torch.float64)
    same64, dead_inf64, err64, launched64 = compare(q64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plain()
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - base
    ms = median_ms(kernel)
    ms64 = median_ms(lambda: kernel(q64))
    plain_ms = median_ms(plain, runs=5, calls=3)
    bound_ms, bound_by, nbytes, flops, rows = nn27_bound(torch, m, q, qmask,
                                                         vs, probes)
    row = {"phase": "nn27", "config": NN27_CONFIG, "frame": frame,
           "B": int(qmask.shape[0]), "N": int(qmask.shape[1]),
           "live_queries": int(qmask.sum()),
           "fallback_rows": fell, "table": list(m.table.shape),
           "launches_per_call": launched, "bit_equal_on_live": same,
           "dead_dist_inf": dead_inf, "max_abs_err": err,
           "float64": {"launches_per_call": launched64,
                       "bit_equal_on_live": same64,
                       "dead_dist_inf": dead_inf64, "max_abs_err": err64,
                       "ms": ms64},
           "ms": ms, "plain_ms": plain_ms, "plain_peak_bytes": plain_peak,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
           "bound_flops": flops, "bound_distinct_rows": rows,
           "library_ms": None}
    row["checks"] = {"one_launch_a_call": launched == launched64 == 1,
                     "bit_equal_on_live": same and same64,
                     "dead_dist_inf": dead_inf and dead_inf64,
                     "live_queries": row["live_queries"] > 0,
                     "within_bound": ms >= bound_ms}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"nn27 failed: {row['checks']}")
    return row


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_drives(seqs):
    return [{"frames": s["frames"][:SHARD_FRAMES],
             "rel_odometry": s["rel_odometry"][:SHARD_FRAMES]}
            for s in seqs[:SHARD_BATCH]]


def sharded_runner(torch, np, mesh, drives, ext, how="run_device"):
    """``BatchedOdometryRunner`` on ``mesh`` over ``drives`` (headline
    config) by ``how``: over their first 3 frames (which captures the
    frame on NCCL), then from a fresh state over the whole drives, the
    collective count and the peer kernel's launch count
    (``peer.LAUNCHES``, which the caller reads) set to 0 just before, the
    collectives read just after.  Returns (poses (B, F, 4, 4), seconds,
    collectives outside the GN loop (the host count), overflow warnings,
    the runner)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.parallel import (BatchedOdometryRunner,
                                                  peer, sharded)

    cfg = Config(**HEADLINE)
    runner = BatchedOdometryRunner(cfg, len(drives), mesh=mesh,
                                   extrinsic=ext)
    getattr(runner, how)([{k: v[:3] for k, v in d.items()} for d in drives])
    runner.state = sharded.init_sharded_state(cfg, mesh, len(drives))
    runner.poses = [[] for _ in drives]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        sharded.COLLECTIVES = peer.LAUNCHES = 0
        t0 = time.perf_counter()
        poses = getattr(runner, how)(drives)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        collectives = sharded.COLLECTIVES
    overflow = [str(w.message) for w in caught
                if "capacity overflow" in str(w.message)]
    return np.asarray(poses), seconds, collectives, overflow, runner


def peer_shapes(torch):
    """The map axis's reductions at the sharded path's shapes, by name:
    (dtype, op, elements) for SHARD_BATCH sequences: 6 float32 sums each
    (the normal equations), an int32 minimum a query (the packed keys),
    an int32 sum each (the correspondence count), and a float64 state's 6
    sums each: every instance of the kernel; and the packed keys of a data
    rank's STOCK_SEQUENCES stock-``Config`` sequences, and of its
    BEYOND_SLOT_SEQUENCES, more than a slot of the kernel (a launch a
    slot)."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch import Config

    return {"normal_equations": (torch.float32, dist.ReduceOp.SUM,
                                 SHARD_BATCH * 6),
            "packed_keys": (torch.int32, dist.ReduceOp.MIN,
                            SHARD_BATCH * HEADLINE["max_source"]),
            "correspondences": (torch.int32, dist.ReduceOp.SUM, SHARD_BATCH),
            "normal_equations_f64": (torch.float64, dist.ReduceOp.SUM,
                                     SHARD_BATCH * 6),
            "packed_keys_stock": (torch.int32, dist.ReduceOp.MIN,
                                  STOCK_SEQUENCES * Config().max_source),
            "packed_keys_beyond_slot": (
                torch.int32, dist.ReduceOp.MIN,
                BEYOND_SLOT_SEQUENCES * Config().max_source)}


def peer_parts(torch, np, rng, dtype, n, size, dev):
    """``size`` random parts of one reduction, one a rank, on ``dev``."""
    if dtype == torch.int32:
        return [torch.from_numpy(rng.integers(
            0, 2**31 - 1, n, dtype=np.int32)).to(dev) for _ in range(size)]
    return [torch.from_numpy(rng.normal(0, 100.0, n)).to(dtype).to(dev)
            for _ in range(size)]


def peer_across_processes(torch, np, group, dev):
    """The peer kernel over ``group`` (one rank a process): regions mapped
    with CUDA IPC by ``peer.attach``, three rounds of each of
    ``peer_shapes``' reductions (the same seeded parts on every rank) held
    bit for bit to the plain version, then every rank unmaps before any
    frees, as ``parallel.shutdown_distributed`` does.  Returns whether
    every round matched."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import peer

    size, rank = dist.get_world_size(group), dist.get_rank(group)
    mine = peer.attach(group, dev)
    ok = True
    try:
        for k, (dtype, op, n) in enumerate(peer_shapes(torch).values()):
            for r in range(3):
                parts = peer_parts(torch, np, np.random.default_rng(
                    [k, r]), dtype, n, size, dev)
                got = parts[rank].clone()
                mine.all_reduce(got, op)
                torch.cuda.synchronize()
                ok &= bits_equal(torch, got, peer.reference(parts, op))
    finally:
        torch.cuda.synchronize()
        dist.barrier(group)
        mine.close()
        dist.barrier(group)
        mine.free()
    return bool(ok)


def peer_bound(nbytes, m, cards):
    """(bound_ms, what bounds it) of one all-reduce of ``nbytes`` over
    ``m`` ranks, every input read once and every output written once: on
    one card that all share (``cards`` 1), 2 m ``nbytes`` of HBM; across
    ``m`` cards the longer of each card's 2 ``nbytes`` of HBM and the 2 (m
    - 1) / m ``nbytes`` each must receive over NVLink."""
    if cards == 1:
        return 2 * m * nbytes / HBM_BYTES_PER_S * 1e3, "HBM"
    hbm = 2 * nbytes / HBM_BYTES_PER_S
    link = 2 * (m - 1) / m * nbytes / NVLINK_BYTES_PER_S
    return max(hbm, link) * 1e3, "NVLink" if link >= hbm else "HBM"


def reductions_ms(torch, launch, streams=(), runs=TIMED_RUNS,
                  calls=CALLS_PER_RUN):
    """Median over ``runs`` of the device ms a call of ``launch()`` (one
    reduction on each of ``streams``, or on the current stream), ``calls``
    calls back to back between two events.  One call first, after a spin
    longer than the run takes to issue, brings the ranks (streams of this
    process or processes of a group) to the same point: its barrier
    absorbs their skew, and the events time the calls after it."""
    here = torch.cuda.current_stream()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        # ~10 ms of spin, longer than the launches take to issue
        torch.cuda._sleep(20_000_000)
        for st in streams:
            st.wait_stream(here)
        launch()
        for st in streams:
            here.wait_stream(st)
        start.record()
        for st in streams:
            st.wait_stream(here)
        for _ in range(calls):
            launch()
        for st in streams:
            here.wait_stream(st)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def peer_phase(torch, np):
    """The map axis's all-reduce over peer memory on this card: peer groups
    of 1, 2 and 4 ranks (``parallel.peer.local_groups``, each with the grid
    that shares the card among them), each rank's kernel launched on a
    stream of its own, at ``peer_shapes``, three rounds each, then each
    rank's reduction captured in a graph of its own and replayed twice,
    every rank bit-equal to the plain version (``peer.reference``:
    rank-order sums and minima) every time; at 2 ranks one reduction inside
    a ``cuda_graph.when`` body, replayed with the predicate set and clear;
    the kernel's ms at 1, 2 and 4 ranks, the plain version's over as many
    parts, and the bound (HBM: every rank's part read once, every result
    written once).  (``sharded_2rank`` runs it across two processes.)"""
    from kinematic_icp_tpu_torch.parallel import peer

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    shapes = peer_shapes(torch)

    def parts(dtype, n, size):
        return peer_parts(torch, np, rng, dtype, n, size, dev)

    def launch_all(groups, streams, tensors, op):
        for g, st, t in zip(groups, streams, tensors):
            with torch.cuda.stream(st):
                g.all_reduce(t, op)

    equal, ms, plain, bound, grids, ctas = {}, {}, {}, {}, {}, {}
    for size in (1, 2, 4):
        groups = peer.local_groups(dev, size)
        grids[size] = groups[0].grid
        streams = [torch.cuda.Stream(dev) for _ in range(size)]
        try:
            for name, (dtype, op, n) in shapes.items():
                itemsize = torch.empty((), dtype=dtype).element_size()
                key = f"{name}_{size}_ranks"
                ctas[key] = peer.ctas(min(n, peer.SLOT_BYTES // itemsize),
                                      itemsize, groups[0].grid)
                ok = True
                for _ in range(3):
                    given = parts(dtype, n, size)
                    want = peer.reference(given, op)
                    got = [t.clone() for t in given]
                    torch.cuda.synchronize()
                    launch_all(groups, streams, got, op)
                    torch.cuda.synchronize()
                    ok &= all(bits_equal(torch, t, want) for t in got)
                equal[key] = bool(ok)
                # each rank's reduction as a graph of its own, replayed
                # twice at once on the ranks' streams
                data = [t.clone() for t in given]
                graphs = []
                for g, st, t in zip(groups, streams, data):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.stream(st):
                        graph.capture_begin()
                        try:
                            g.all_reduce(t, op)
                        finally:
                            graph.capture_end()
                    graphs.append(graph)
                ok = True
                for _ in range(2):
                    for t, p in zip(data, given):
                        t.copy_(p)
                    torch.cuda.synchronize()
                    for graph, st in zip(graphs, streams):
                        with torch.cuda.stream(st):
                            graph.replay()
                    torch.cuda.synchronize()
                    ok &= all(bits_equal(torch, t, want) for t in data)
                equal[f"{key}_captured"] = bool(ok)
                del graphs
                ms[key] = reductions_ms(
                    torch, lambda: launch_all(groups, streams, got, op),
                    streams)
                plain[key] = median_ms(lambda: peer.reference(given, op))
                bound[key] = peer_bound(n * itemsize, size, 1)[0]
            if size == 2:
                equal["inside_an_if_node_2_ranks"] = peer_in_if_node(
                    torch, groups, streams)
        finally:
            torch.cuda.synchronize()
            for g in groups:
                g.free()
    row = {"phase": "peer_reduce", "route": "cuda",
           "source": "kinematic_icp_tpu_torch/csrc/peer_reduce.cu",
           "shapes": {k: [str(d), str(o), n] for k, (d, o, n)
                      in shapes.items()},
           "grid_by_ranks": grids, "ctas_a_launch": ctas,
           "algorithm_by_shape_at_4_ranks": {
               k: peer.algorithm(min(n * torch.empty((), dtype=d)
                                     .element_size(), peer.SLOT_BYTES), 4)
               for k, (d, o, n) in shapes.items()},
           "ms": ms, "plain_ms": plain, "bound_ms": bound,
           "bound_by": "bytes (HBM)",
           "checks": {f"bit_equal_to_plain_{k}": v
                      for k, v in equal.items()}}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"peer_reduce failed: {row['checks']}")
    return row


def peer_in_if_node(torch, groups, streams):
    """Each rank of ``groups`` (on ``streams``) reducing 12 float32 sums
    inside a ``cuda_graph.when`` body of a graph of its own, the graphs
    replayed at once with the predicate set and clear in turns: the sums
    where set, the data as it was where clear.  Returns whether every
    replay matched."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.utils import cuda_graph

    dev = groups[0].device
    data = [torch.zeros(12, device=dev) for _ in groups]
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    graphs = []
    for g, st, t in zip(groups, streams, data):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(st):
            graph.capture_begin()
            capture = cuda_graph._active = cuda_graph._Capture(dev)
            try:
                cuda_graph.when(pred, lambda g=g, t=t: g.all_reduce(
                    t, dist.ReduceOp.SUM))
            finally:
                cuda_graph._active = None
                graph.capture_end()
                capture.close()
        graphs.append(graph)
    ok = True
    for k in range(4):
        for r, t in enumerate(data):
            t.fill_(r + 1.0 + k)
        pred.fill_(k % 2 == 1)
        torch.cuda.synchronize()
        for graph, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        total = sum(r + 1.0 + k for r in range(len(data)))
        ok &= all(t.tolist() == [total if k % 2 else r + 1.0 + k] * 12
                  for r, t in enumerate(data))
    return bool(ok)


def sharded_1rank_phase(torch, np, seqs):
    """The map-sharded path on a one-rank NCCL group and a (1, 1) mesh:
    ``BatchedOdometryRunner(mesh=...)`` over SHARD_BATCH headline drives
    (``run_device`` timed; ``run`` within 1e-5 of it), bit-equal to the
    unsharded runner's loop lowering (the sharded path runs no GN kernel,
    by design), each drive within 5 mm of its ``run_offline`` (which runs
    the kernel); its route ("none": a map group of one rank reduces
    nothing).  Then the NCCL-route row beside it (``sharded_nccl_route``):
    bit-equal to it, one graph a frame with no IF body, NCCL's collectives
    counted (1 a frame outside the GN loop on the host; every trip's, 2 x
    10 + 2 a loop, on the device), ms a batched frame and frames/s.
    Returns (row, the run_device poses (B, F, 4, 4))."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import gn, hashmap
    from kinematic_icp_tpu_torch.parallel import (BatchedOdometryRunner,
                                                  initialize_distributed,
                                                  make_mesh, map_route,
                                                  shutdown_distributed)
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    drives = sharded_drives(seqs)
    ext = seqs[0]["extrinsic"]
    initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        backend = dist.get_backend()
        mesh = make_mesh(1, 1)
        gn.LAUNCHES = 0
        device, seconds, collectives, overflow, runner = sharded_runner(
            torch, np, mesh, drives, ext)
        launches = gn.LAUNCHES
        stepped, step_s, _, step_overflow, _ = sharded_runner(
            torch, np, mesh, drives, ext, how="run")
        voxels = hashmap.num_voxels(runner.state.map).tolist()
        # NCCL's collectives inside the frame's graph (read before the
        # shutdown frees the graphs)
        path = path_of(runner._seq_runner.step.calls)
        nccl_route = sharded_nccl_route(torch, np, drives, ext)
    finally:
        shutdown_distributed()
    loop = np.asarray(BatchedOdometryRunner(
        Config(**HEADLINE, gn_backend="torch"), SHARD_BATCH,
        extrinsic=ext).run_device(drives))
    bits = sum(bool(np.array_equal(device[:, f], loop[:, f]))
               for f in range(SHARD_FRAMES))
    ate = [ate_rmse(run_drive(torch, s, Config(**HEADLINE), SHARD_FRAMES)[0],
                    device[i], align=False)
           for i, s in enumerate(seqs[:SHARD_BATCH])]
    step_diff = float(np.abs(stepped - device).max())
    row = {"phase": "sharded_1rank", "backend": backend, "mesh": [1, 1],
           "route": map_route(mesh), "path": path,
           "B": SHARD_BATCH, "frames": SHARD_FRAMES, "config": HEADLINE,
           "seconds": seconds, "ms_per_frame": seconds * 1e3 / SHARD_FRAMES,
           "run_ms_per_frame": step_s * 1e3 / SHARD_FRAMES,
           "collectives_per_frame": collectives / SHARD_FRAMES,
           "gn_launches": launches,
           "frames_bit_equal_to_unsharded_loop": bits,
           "run_vs_run_device_max_abs": step_diff,
           "ate_vs_run_offline_m": ate, "voxels": voxels,
           "overflow": overflow or [0, 0, 0]}
    row["checks"] = {
        "finite": bool(np.isfinite(device).all()),
        "run_within_1e-5_of_run_device": step_diff <= 1e-5,
        "bit_equal_to_unsharded_loop": bits == SHARD_FRAMES,
        "each_within_5mm_of_run_offline": max(ate) < 5e-3,
        "zero_overflow": not overflow and not step_overflow,
        "captured_on_nccl": row["path"] == "graph",
        # the insert failures' SUM a frame (the GN loop's collectives are
        # counted on the device, in the graph phase's sharded row)
        "one_collective_a_frame_outside_the_loop":
            collectives == SHARD_FRAMES,
        # collectives cannot run inside a kernel
        "no_gn_kernel_by_design": launches == 0}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"sharded_1rank failed: {row['checks']}")
    nccl_poses = nccl_route.pop("poses")
    bits = sum(bool(np.array_equal(nccl_poses[:, f], device[:, f]))
               for f in range(SHARD_FRAMES))
    trips = Config().max_num_iterations
    # β's SUM before the first trip and the correspondence count's after
    # the last
    around = int(Config().use_adaptive_odometry_regularization) + 1
    loops = nccl_route["loop_counts"]
    nccl_row = {"phase": "sharded_1rank_nccl_route", **nccl_route,
                "frames_bit_equal_to_sharded_1rank": bits}
    nccl_row["checks"] = {
        "finite": bool(np.isfinite(nccl_poses).all()),
        "route_nccl": nccl_route["route"] == "nccl",
        "bit_equal_to_sharded_1rank": bits == SHARD_FRAMES,
        "zero_overflow": not nccl_route["overflow"],
        "captured_on_nccl": nccl_route["path"] == "graph",
        "no_if_body_in_the_frame": nccl_route["if_bodies"] == 0,
        "one_collective_a_frame_outside_the_loop":
            nccl_route["collectives_per_frame"] == 1,
        # the loop is not gated: every trip's collectives, replayed
        "every_trip_a_loop": loops["gn_loops"] == SHARD_FRAMES
        and loops["associations"] == trips * SHARD_FRAMES,
        "loop_collectives_every_trip":
            loops["loop_collectives"] == (2 * trips + around) * SHARD_FRAMES,
        "no_gn_kernel_by_design": nccl_route["gn_launches"] == 0}
    emit(nccl_row)
    if not all(nccl_row["checks"].values()):
        raise SystemExit(f"sharded_1rank_nccl_route failed: "
                         f"{nccl_row['checks']}")
    return row, device


def sharded_nccl_route(torch, np, drives, ext):
    """``drives`` on a (1, 1) mesh of the current one-rank NCCL group
    forced onto the "nccl" route (``make_mesh(map_reduce="nccl")``: NCCL's
    ``all_reduce`` over the one rank, captured in the frame's graph, the GN
    loop not gated): the timed run (``sharded_runner``), the IF bodies its
    graphs hold, and the same frames again with the GN loop's work and
    collectives counted on the device (``counted_run``, on graphs captured
    again for it).  Returns the row's fields and its ``poses``."""
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.parallel import make_mesh, map_route, sharded

    mesh = make_mesh(1, 1, map_reduce="nccl")
    gn.LAUNCHES = 0
    poses, seconds, collectives, overflow, runner = sharded_runner(
        torch, np, mesh, drives, ext)
    launches = gn.LAUNCHES
    step = runner._seq_runner.step
    path = path_of(step.calls)
    bodies = sum(len(c.body_pools) for c in step.calls)

    def fresh(frames):
        runner.state = sharded.init_sharded_state(runner.config, mesh,
                                                  len(drives))
        runner.poses = [[] for _ in drives]
        runner.run_device([{k: v[:frames] for k, v in d.items()}
                           for d in drives])
        torch.cuda.synchronize()

    loops = counted_run(torch, step.release, lambda: fresh(SHARD_FRAMES),
                        lambda: fresh(3))
    return {"route": map_route(mesh), "backend": "nccl", "mesh": [1, 1],
            "path": path, "if_bodies": bodies, "B": len(drives),
            "frames": SHARD_FRAMES, "seconds": seconds,
            "ms_per_frame": seconds * 1e3 / SHARD_FRAMES,
            "frames_per_s": len(drives) * SHARD_FRAMES / seconds,
            "collectives_per_frame": collectives / SHARD_FRAMES,
            "loop_counts": loops,
            "loop_collectives_per_frame":
                loops["loop_collectives"] / SHARD_FRAMES,
            "gn_launches": launches, "overflow": overflow, "poses": poses}


def loop_batch_phase(torch, np, seqs):
    """The GN loop lowering through the unsharded ``BatchedOdometryRunner``
    over LOOP_BATCH headline drives at once and over each drive alone
    (B = 1), LOOP_BATCH_FRAMES frames: every frame bit-equal, since each
    float sum of the loop is ``points.row_sum``'s fixed tree."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner

    config = dict(HEADLINE, gn_backend="torch")
    cfg = Config(**config)
    drives = [{"frames": s["frames"][:LOOP_BATCH_FRAMES],
               "rel_odometry": s["rel_odometry"][:LOOP_BATCH_FRAMES]}
              for s in seqs[:LOOP_BATCH]]
    ext = seqs[0]["extrinsic"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        batched = np.asarray(BatchedOdometryRunner(
            cfg, LOOP_BATCH, extrinsic=ext).run_device(drives))
        alone = np.stack([np.asarray(BatchedOdometryRunner(
            cfg, 1, extrinsic=ext).run_device([d]))[0] for d in drives])
    overflow = [str(w.message) for w in caught
                if "capacity overflow" in str(w.message)]
    by_drive = [sum(bool(np.array_equal(batched[i, f], alone[i, f]))
                    for f in range(LOOP_BATCH_FRAMES))
                for i in range(LOOP_BATCH)]
    row = {"phase": "loop_batch", "B": LOOP_BATCH,
           "frames": LOOP_BATCH_FRAMES, "config": config,
           "frames_bit_equal_to_b1_loop_by_drive": by_drive,
           "max_abs_vs_b1_loop": float(np.abs(batched - alone).max()),
           "overflow": overflow or [0, 0, 0]}
    row["checks"] = {
        "finite": bool(np.isfinite(batched).all()),
        "bit_equal_to_b1_every_frame":
            sum(by_drive) == LOOP_BATCH * LOOP_BATCH_FRAMES,
        "zero_overflow": not overflow}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"loop_batch failed: {row['checks']}")
    return row


def sharded_worker(rank, port, out_dir):
    """One rank of the two-rank phase (``chip_smoke.py --sharded-worker
    RANK PORT DIR``): a gloo group of two processes on the one card, a
    (1, 2) mesh, the peer kernel across the two processes
    (``peer_across_processes``), the sharded runner over the SHARD_BATCH
    headline drives on gloo's route, then again with the map axis forced
    onto the peer kernel (``make_mesh(map_reduce="peer")``: the frame
    eager, as on gloo, each map-axis reduction a launch of the kernel a
    slot, counted in ``peer.LAUNCHES``); writes its poses and counts to
    DIR."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.ops import hashmap
    from kinematic_icp_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh, map_route, peer,
                                                  sharded,
                                                  shutdown_distributed)

    rank = int(rank)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(1, 2)
        group = mesh.get_group("map")
        dev = sharded.mesh_device(mesh)
        # gloo reduces CUDA tensors through host memory: int32 MIN and
        # float32 SUM, the sharded path's two reductions
        least = torch.tensor([rank + 1, 4 - rank], dtype=torch.int32,
                             device=dev)
        dist.all_reduce(least, op=dist.ReduceOp.MIN, group=group)
        sums = torch.full((3,), rank + 0.25, device=dev)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        gloo_cuda = (least.is_cuda and least.tolist() == [1, 3]
                     and sums.tolist() == [1.5] * 3)
        # the peer kernel across the two processes, over the gloo group
        peer_ok = peer_across_processes(torch, np, group, dev)
        seqs = [headline_drive(s) for s in range(SHARD_BATCH)]
        drives = sharded_drives(seqs)
        ext = seqs[0]["extrinsic"]
        poses, seconds, collectives, overflow, runner = sharded_runner(
            torch, np, mesh, drives, ext)
        m = runner.state.map
        k = m.block_size
        slots = m.table.view(*m.table.shape[:-1], m.bucket_slots, k + 4)
        keys = slots[..., k + 1:][slots[..., k] != 0]
        owner = sharded._owner_of(keys[:, 0], keys[:, 1], keys[:, 2], 2)
        # the main path of the peer kernel: the same drives, the map axis
        # on the peer route
        peer_mesh = make_mesh(1, 2, map_reduce="peer")
        peer_poses, peer_s, _, peer_overflow, _ = sharded_runner(
            torch, np, peer_mesh, drives, ext)
        peer_launches = peer.LAUNCHES
        meta = {"rank": rank, "backend": dist.get_backend(),
                "peer_route": map_route(peer_mesh),
                "peer_route_bit_equal_to_gloo_route": bool(
                    np.array_equal(peer_poses, poses)),
                "peer_route_seconds": peer_s,
                "peer_route_overflow": peer_overflow or [0, 0, 0],
                "peer_launches": peer_launches,
                "device": str(dev), "gloo_cuda_int32_min_f32_sum": gloo_cuda,
                "peer_across_processes_bit_equal_to_plain": peer_ok,
                "seconds": seconds, "collectives": collectives,
                "path": path_of(runner._seq_runner.step.calls),
                "overflow": overflow or [0, 0, 0],
                "voxels": hashmap.num_voxels(m).tolist(),
                "every_voxel_on_its_owner": bool(
                    (owner == mesh.get_local_rank("map")).all())}
    finally:
        shutdown_distributed()
    np.save(os.path.join(out_dir, f"poses{rank}.npy"), poses)
    with open(os.path.join(out_dir, f"meta{rank}.json"), "w") as f:
        json.dump(meta, f)
    print(f"sharded worker {rank}: OK", flush=True)
    return 0


def sharded_2rank_phase(torch, np, one_rank):
    """Two ranks on the one card: this script as two worker processes
    (gloo, a (1, 2) mesh: each sequence's map split over the two), each
    under a wall limit; each drive within 5 mm of the one-rank run, every
    stored voxel on its owner's rank; the same drives on the peer route
    (the peer kernel's main path: its launches counted around that run)
    bit-equal to gloo's route (two ranks' sums in either order are one
    rounding)."""
    import tempfile

    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    with tempfile.TemporaryDirectory(prefix="kicp_sharded_") as tmp:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-worker",
             str(r), str(port), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARD_WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            raise SystemExit(f"sharded_2rank: a worker ran past "
                             f"{SHARD_WORKER_TIMEOUT_S} s")
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0 or f"sharded worker {r}: OK" not in log:
                print(log[-4000:], file=sys.stderr)
                raise SystemExit(f"sharded_2rank: worker {r} failed "
                                 f"(exit {p.returncode})")
        poses = [np.load(os.path.join(tmp, f"poses{r}.npy")) for r in (0, 1)]
        meta = []
        for r in (0, 1):
            with open(os.path.join(tmp, f"meta{r}.json")) as f:
                meta.append(json.load(f))
    ate = [ate_rmse(one_rank[i], poses[0][i], align=False)
           for i in range(SHARD_BATCH)]
    seconds = max(m["seconds"] for m in meta)
    row = {"phase": "sharded_2rank", "backend": meta[0]["backend"],
           # gloo's collectives cannot be captured
           "path": meta[0]["path"],
           "mesh": [1, 2], "B": SHARD_BATCH, "frames": SHARD_FRAMES,
           "devices": [m["device"] for m in meta], "seconds": seconds,
           "ms_per_frame": seconds * 1e3 / SHARD_FRAMES,
           "collectives_per_frame": meta[0]["collectives"] / SHARD_FRAMES,
           "ate_vs_one_rank_m": ate,
           "max_abs_vs_one_rank": float(np.abs(poses[0] - one_rank).max()),
           "voxels_per_shard": [m["voxels"] for m in meta],
           "overflow": [m["overflow"] for m in meta],
           "peer_route": {
               "route": meta[0]["peer_route"],
               "ms_per_frame": max(m["peer_route_seconds"] for m in meta)
               * 1e3 / SHARD_FRAMES,
               "peer_launches_by_rank": [m["peer_launches"] for m in meta],
               "peer_launches_per_frame": meta[0]["peer_launches"]
               / SHARD_FRAMES,
               "overflow": [m["peer_route_overflow"] for m in meta]}}
    row["checks"] = {
        "gloo_takes_cuda_int32_min_and_f32_sum": all(
            m["gloo_cuda_int32_min_f32_sum"] for m in meta),
        "peer_kernel_across_processes_bit_equal_to_plain": all(
            m["peer_across_processes_bit_equal_to_plain"] for m in meta),
        "finite": all(bool(np.isfinite(p).all()) for p in poses),
        "ranks_agree": bool(np.array_equal(poses[0], poses[1])),
        "each_within_5mm_of_one_rank": max(ate) < 5e-3,
        "zero_overflow": all(m["overflow"] == [0, 0, 0] for m in meta),
        "eager_on_gloo": all(m["path"] == "eager" for m in meta),
        "every_voxel_on_its_owner": all(m["every_voxel_on_its_owner"]
                                        for m in meta),
        "both_shards_hold_voxels": all(min(m["voxels"]) > 0 for m in meta),
        "peer_route_taken": all(m["peer_route"] == "peer" for m in meta),
        "peer_route_bit_equal_to_gloo_route": all(
            m["peer_route_bit_equal_to_gloo_route"] for m in meta),
        "peer_kernel_launched_on_its_path": all(
            m["peer_launches"] > 0 for m in meta),
        "peer_route_zero_overflow": all(
            m["peer_route_overflow"] == [0, 0, 0] for m in meta)}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"sharded_2rank failed: {row['checks']}")
    return row


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
           "path": path_of(server_calls(blocking)),
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
               "path": path_of(server_calls(s)),
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


def path_of(calls):
    """"graph" where every static call a path ran
    (``utils.cuda_graph.StaticCall``) replayed CUDA graphs, "eager" where
    one ran op by op (or the path ran none: the eager loop)."""
    calls = list(calls)
    return "graph" if calls and all(c.graphs for c in calls) else "eager"


def runner_calls(torch, config, batched=False):
    """The static calls of the cached sequence runner (``batched``: the
    batched one) under ``config`` on the card: what ``run_offline`` and
    ``run_batched`` ran."""
    from kinematic_icp_tpu_torch.offline import (
        make_batched_sequence_runner, make_sequence_runner)

    make = make_batched_sequence_runner if batched else make_sequence_runner
    step = make(config, torch.device("cuda")).step
    return [] if step is None else step.calls


def server_calls(server):
    return [call for _, call in server._calls.values()]


def pool_bytes(torch, pool, calls):
    """Bytes the caching allocator holds for an owner's graphs: its shared
    memory pool and the pools of the static ``calls``' IF bodies."""
    pools = {tuple(pool), *(tuple(p) for c in calls for p in c.body_pools)}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def profiled(torch, run, frames, marker, per_marker):
    """``utils.profiling.device_profile`` of ``run()`` (``frames`` frames
    that end in a readback) under ``torch.profiler``, a frame's host calls
    counted between the first and the last ``marker`` call (the GN
    kernel's launch on an eager loop, a graph launch), ``per_marker``
    frames each (None where a frame's count of them varies: an exact
    frame's two or three graph launches)."""
    from torch.profiler import ProfilerActivity, profile

    from kinematic_icp_tpu_torch.utils.profiling import device_profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_profile(prof, wall, frames, marker, per_marker,
                          kernel="gn_solve_kernel")


def reset_counts():
    """Set the launch and collective counters to 0."""
    from kinematic_icp_tpu_torch.ops import gn, nn27
    from kinematic_icp_tpu_torch.parallel import sharded

    gn.LAUNCHES = gn.CROSSING_LAUNCHES = sharded.COLLECTIVES = 0
    nn27.LAUNCHES = 0


def read_counts():
    """The counters ``reset_counts`` zeroes: GN launches, ``check_crossing``
    launches, the sharded frame's collectives outside its GN loop and the
    full-27 association kernel's launches, issued or captured (host counts:
    a replay adds no ``nn27`` launch, since they all lie in conditional
    bodies; ``device_counts`` counts those a replay runs)."""
    from kinematic_icp_tpu_torch.ops import gn, nn27
    from kinematic_icp_tpu_torch.parallel import sharded

    return {"gn_launches": gn.LAUNCHES,
            "check_crossing_launches": gn.CROSSING_LAUNCHES,
            "collectives": sharded.COLLECTIVES,
            "nn27_launches": nn27.LAUNCHES}


#: the names of ``device_counts``' counts
LOOP_COUNTS = ("gn_loops", "associations", "loop_iterations",
               "fallback_registrations", "loop_collectives", "nn27_launches")


@contextlib.contextmanager
def device_counts(torch, device="cuda"):
    """Count, in a (6,) int64 tensor on ``device``, the GN loop's work that
    a replay can no longer show the host: the ``registration.run_gn`` calls
    that ran, the associations they made, each call's most iterations of a
    row, summed, the registrations whose exact-mode fallback flags have a
    row set, the map-axis collectives issued while ``run_gn`` runs
    (``parallel.sharded._all_reduce``: β's, each trip's and the
    correspondence count's SUM, each association's MIN), and the launches
    of the full-27 association kernel (``nn27.nearest_neighbor``, which
    ``hashmap.nearest_neighbor`` calls where it applies).  Each count is a
    device op where its work is, inside whatever conditional node holds
    it, so a replay counts what it ran.  Graphs captured inside the
    ``with`` hold the counting ops; a capture's warm-up counts too (zero
    the tensor after it)."""
    from kinematic_icp_tpu_torch.ops import nn27, registration
    from kinematic_icp_tpu_torch.parallel import sharded

    counts = torch.zeros(6, dtype=torch.int64, device=device)
    run_gn, motion = registration.run_gn, registration.compute_robot_motion
    all_reduce, nearest = sharded._all_reduce, nn27.nearest_neighbor
    in_loop = [False]

    def counting_run_gn(associate, *args, **kw):
        counts[0].add_(1)

        def counted(pose):
            counts[1].add_(1)
            return associate(pose)

        in_loop[0] = True
        try:
            out = run_gn(counted, *args, **kw)
        finally:
            in_loop[0] = False
        counts[2].add_(out[1].max().to(torch.int64))
        return out

    def counting_motion(*args, **kw):
        pose, debug = motion(*args, **kw)
        if debug.exact_fallback is not None:
            counts[3].add_(debug.exact_fallback.any().to(torch.int64))
        return pose, debug

    def counting_all_reduce(t, op, axes):
        if in_loop[0]:
            counts[4].add_(1)
        return all_reduce(t, op, axes)

    def counting_nearest(*args, **kw):
        counts[5].add_(1)
        return nearest(*args, **kw)

    registration.run_gn = counting_run_gn
    registration.compute_robot_motion = counting_motion
    sharded._all_reduce = counting_all_reduce
    nn27.nearest_neighbor = counting_nearest
    try:
        yield counts
    finally:
        registration.run_gn = run_gn
        registration.compute_robot_motion = motion
        sharded._all_reduce = all_reduce
        nn27.nearest_neighbor = nearest


def counted_run(torch, release, run, warm):
    """``run()`` under ``device_counts``, after ``release()`` (which frees
    the graphs a run replays, so that ``warm()`` captures them anew with
    the counting ops; its counts are dropped); the graphs are freed again
    after, so a later run captures without them.  Returns the counts by
    name (``LOOP_COUNTS``)."""
    with device_counts(torch) as counts:
        release()
        try:
            warm()
            counts.zero_()
            run()
            got = counts.tolist()
        finally:
            release()
    return dict(zip(LOOP_COUNTS, got))


def graph_drive(torch, np, seqs, config, count, eager, markers, mesh=None,
                loops=False):
    """The sequence runner over one drive (a dict), or the batched runner
    over a list of drives (with ``mesh``, the map-sharded runner on it),
    ``count`` frames, on its graphs or (``eager``) on the eager loop: a
    3-frame run first (it captures the graphs), then the timed run (the
    inputs padded and on the card before the clock, the poses read back
    inside it), then GRAPH_PROFILED_FRAMES frames under the profiler,
    ``markers`` (marker, frames a marker) starting its frames.  The counts
    are set to 0 just before the timed run and read just after.  With
    ``loops`` (a path that runs the GN loop) the ``count`` frames run once
    more under ``device_counts``, on graphs captured again for it."""
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import (
        init_batched_state, make_batched_sequence_runner,
        make_sequence_runner, pad_batch, pad_sequence)
    from kinematic_icp_tpu_torch.parallel import map_route, sharded

    dev = torch.device("cuda")
    batched = isinstance(seqs, list)
    first = seqs[0] if batched else seqs

    def inputs(n):
        if batched:
            arrays = pad_batch([dict(s, frames=s["frames"][:n],
                                     rel_odometry=s["rel_odometry"][:n])
                                for s in seqs], config)
        else:
            arrays = pad_sequence(first["frames"][:n],
                                  first["rel_odometry"][:n], config)
        return [torch.from_numpy(a).to(dev) for a in arrays]

    if mesh is not None:
        runner = sharded.make_sharded_sequence_runner(config, mesh,
                                                      eager=eager)
    elif batched:
        runner = make_batched_sequence_runner(config, dev, eager=eager)
    else:
        runner = make_sequence_runner(config, dev, eager=eager)
    ext = torch.tensor(np.asarray(first["extrinsic"], np.float32),
                       device=dev)

    def run(arrays):
        if mesh is not None:
            state = sharded.init_sharded_state(config, mesh, len(seqs))
        elif batched:
            state = init_batched_state(config, len(seqs), device=dev)
        else:
            state = pipeline.init_state(config, device=dev)
        out = runner(state, *arrays[:4], ext, arrays[4])
        # poses, overflow and fallbacks; the sharded runner counts no
        # fallbacks (no certificate)
        return tuple(x.cpu().numpy()
                     for x in out[1:3 if mesh is not None else 4])

    run(inputs(3))
    arrays = inputs(count)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    poses, overflow, *fallbacks = run(arrays)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    few = inputs(GRAPH_PROFILED_FRAMES)
    prof = profiled(torch, lambda: run(few), GRAPH_PROFILED_FRAMES,
                    *markers)
    calls = [] if runner.step is None else runner.step.calls
    row = {"poses": poses, "overflow": overflow, "seconds": seconds,
           "fallback_frames": fallbacks[0] if fallbacks else None,
           **counts, "profile": prof, "path": path_of(calls),
           "route": None if mesh is None else map_route(mesh),
           "if_bodies": sum(len(c.body_pools) for c in calls),
           "capture_ms": [c.capture_ms for c in calls] or None,
           "graphs": [c.graphs for c in calls],
           "pool_bytes": pool_bytes(torch, runner.step.pool, calls)
           if calls else None, "loop_counts": None}
    if loops:
        row["loop_counts"] = counted_run(
            torch, runner.step.release if runner.step else lambda: None,
            lambda: run(arrays), lambda: run(inputs(3)))
    return row


def graph_serve(torch, np, seq, config, count, mode, eager, markers,
                loops=False):
    """The headline through ``LidarOdometryServer``, blocking or streamed
    in ``"scan"`` chunks, on its graphs or (``eager``) op by op: ``warmup``
    (which captures), the timed ``count`` frames with the counts set to 0
    just before and read just after, then a second server's first
    GRAPH_PROFILED_FRAMES frames under the profiler (``markers`` as
    ``graph_drive``'s).  With ``loops`` a third server serves the
    ``count`` frames under ``device_counts``, captured for it."""
    from kinematic_icp_tpu_torch.server import LidarOdometryServer

    blocking = mode == "blocking"

    def served():
        s = LidarOdometryServer(config, extrinsic=seq["extrinsic"],
                                stream_mode="steps" if blocking else "scan",
                                stream_chunk=SERVE_CHUNK, eager=eager)
        s.warmup(HEADLINE["max_points"], streaming=not blocking)
        return s

    s = served()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    serve_frames(s, seq, range(count), blocking=blocking)
    s.drain()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    other = served()

    def run():
        serve_frames(other, seq, range(GRAPH_PROFILED_FRAMES),
                     blocking=blocking)
        other.drain()

    prof = profiled(torch, run, GRAPH_PROFILED_FRAMES, *markers)
    calls = server_calls(s)
    row = {"poses": stamped_poses(np, s), "seconds": seconds,
           **counts, "fallback_frames": None,
           "frames_registered": s.frames_registered,
           "overflow": s.overflow_stats, "profile": prof,
           "path": path_of(calls), "route": None,
           "if_bodies": sum(len(c.body_pools) for c in calls),
           "capture_ms": None if eager else [c.capture_ms for c in calls],
           "graphs": [c.graphs for c in calls],
           "pool_bytes": None if eager else pool_bytes(torch, s._pool,
                                                       calls),
           "loop_counts": None}
    if loops:
        counted = []

        def warm():
            counted.append(served())

        def serve():
            serve_frames(counted[0], seq, range(count), blocking=blocking)
            counted[0].drain()

        row["loop_counts"] = counted_run(torch, lambda: None, serve, warm)
    return row


#: the markers that start a profiled frame: the GN kernel's launch (one a
#: frame) on an eager loop, a graph launch (one a frame, or a chunk-scan
#: of SERVE_CHUNK) under graphs; every launch of the kernel-free eager
#: loops (pruned, sharded) starts a varying number a frame
COOPERATIVE = ("cudaLaunchCooperativeKernel", 1)
REPLAY = ("cudaGraphLaunch", 1)
ANY_LAUNCH = ("cudaLaunchKernel", None)


def graph_phase(torch, np, seq, drives, card):
    """Each path twice in one call, on the eager loop and on its CUDA
    graphs (the path the entry points take): the default paths (the
    60-frame headline drive, the 20-frame stock ``Config`` drive, the
    batched drive of the 8 headline drives, the served headline, blocking
    and chunk-scan), the exact modes (the 60-frame certified drive, 20
    pruned frames, 4 drives of 20 frames certified under a batch, the
    served certified headline) and the map-sharded runner on a one-rank
    NCCL group (drives 0-1, 20 frames).  For each: every frame bit-equal,
    the same GN, ``check_crossing`` and collective counts (and fallback
    frames), frames/s, host calls and syncs a frame and the device's idle
    share over GRAPH_PROFILED_FRAMES frames under the profiler, the
    capture's ms, one graph a static call and the graph pool's bytes; on
    the paths that run the GN loop, its work counted on the device
    (``device_counts``).  One line a path, a line of re-associations
    against iterations a loop, then a summary line."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh,
                                                  shutdown_distributed)

    headline, stock = Config(**HEADLINE), Config(**STOCK)
    exact, pruned = Config(**EXACT), Config(**PRUNED)
    initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    mesh = make_mesh(1, 1)
    nccl_route = make_mesh(1, 1, map_reduce="nccl")

    def drive(*a, markers=(COOPERATIVE, REPLAY), **kw):
        return lambda e: graph_drive(torch, np, *a, e, markers[1 - e], **kw)

    def serve(config, mode, markers=(COOPERATIVE, REPLAY), **kw):
        return lambda e: graph_serve(torch, np, seq, config, MAIN_FRAMES,
                                     mode, e, markers[1 - e], **kw)

    # (name, run(eager), frames, B, whether the GN kernel runs, whether
    # the frame loop never waits for the device under graphs: a server
    # waits for its upload and its readback)
    cases = [
        ("headline", drive(seq, headline, MAIN_FRAMES), MAIN_FRAMES, 1,
         True, True),
        ("stock_config", drive(seq, stock, STOCK_FRAMES), STOCK_FRAMES, 1,
         True, True),
        (f"batched_b{BATCH}", drive(drives, headline, MAIN_FRAMES),
         MAIN_FRAMES, BATCH, True, True),
        ("serve_blocking", serve(headline, "blocking"), MAIN_FRAMES, 1,
         True, False),
        ("serve_scan", serve(headline, "scan", (COOPERATIVE, (
            "cudaGraphLaunch", SERVE_CHUNK))), MAIN_FRAMES, 1, True, False),
        ("exact_certified", drive(seq, exact, EXACT_FRAMES, loops=True),
         EXACT_FRAMES, 1, True, True),
        ("exact_pruned", drive(seq, pruned, PRUNED_FRAMES,
                               markers=(ANY_LAUNCH, REPLAY), loops=True),
         PRUNED_FRAMES, 1, False, True),
        (f"batched_exact_b{EXACT_BATCH}", drive(
            drives[:EXACT_BATCH], exact, EXACT_BATCH_FRAMES, loops=True),
         EXACT_BATCH_FRAMES, EXACT_BATCH, True, True),
        ("serve_exact_blocking", serve(exact, "blocking", loops=True),
         MAIN_FRAMES, 1, True, False),
        ("sharded_1rank_nccl", drive(
            drives[:SHARD_BATCH], headline, SHARD_FRAMES,
            markers=(ANY_LAUNCH, REPLAY), mesh=mesh, loops=True),
         SHARD_FRAMES, SHARD_BATCH, False, True),
        ("sharded_1rank_nccl_route", drive(
            drives[:SHARD_BATCH], headline, SHARD_FRAMES,
            markers=(ANY_LAUNCH, REPLAY), mesh=nccl_route, loops=True),
         SHARD_FRAMES, SHARD_BATCH, False, True)]
    summary = {}
    try:
        for name, run, count, b, kernel, quiet in cases:
            eager, graph = run(True), run(False)
            summary[name] = graph_row(np, name, count, b, kernel, quiet,
                                      eager, graph, card)
    finally:
        shutdown_distributed()
    emit({"phase": "graph_reassociations", "nvidia_smi": card,
          "paths": {name: {k: row[k] for k in (
              "iterations_a_loop", "reassociations_a_loop",
              "collectives_a_frame", "loop_collectives_a_frame",
              "nn27_launches")}
              for name, row in summary.items()
              if row["iterations_a_loop"] is not None}})
    emit({"phase": "graph", "nvidia_smi": card, "paths": summary})
    return summary


def graph_row(np, name, count, b, kernel, quiet, eager, graph, card):
    """One path's line of the graph phase (it fails the run on a failed
    check); returns its summary.  Where the path runs the GN loop
    (``loop_counts``), the replay runs as many loops as eager, on the same
    frames, and re-associates only as JAX's ``while_loop`` does: 1 + the
    most (iterations - 1) of a row a loop, where eager runs every trip;
    on the sharded path each trip issues a SUM and each association a
    MIN, besides β's and the correspondence count's SUMs, counted on the
    device: 2 trips + 2 a loop, as JAX's trips make them, where eager
    issues every trip's."""
    from kinematic_icp_tpu_torch import Config

    trips = Config().max_num_iterations
    # β's SUM before the first trip (the adaptive regularization) and the
    # correspondence count's after the last
    around = int(Config().use_adaptive_odometry_regularization) + 1
    def both(key, of=None):
        src = (lambda r: r[of][key]) if of else (lambda r: r[key])
        return {"eager": src(eager), "graph": src(graph)}

    equal = sum(bool(np.array_equal(x, y))
                for x, y in zip(graph["poses"], eager["poses"]))
    row = {"phase": f"graph_{name}", "frames": count, "B": b,
           "nvidia_smi": card, "path": both("path"), "route": graph["route"],
           "if_bodies": graph["if_bodies"],
           "frames_bit_equal": equal,
           "frames_per_s": {"eager": b * count / eager["seconds"],
                            "graph": b * count / graph["seconds"]},
           **{k: both(k) for k in ("gn_launches", "check_crossing_launches",
                                   "collectives", "loop_counts")},
           "exact_fallback_frames": {
               k: None if r["fallback_frames"] is None
               else r["fallback_frames"].tolist()
               for k, r in (("eager", eager), ("graph", graph))},
           "profiled_frames": GRAPH_PROFILED_FRAMES,
           **{k: both(k, "profile") for k in (
               "host_calls_per_frame", "host_syncs_per_frame",
               "device_idle_share", "device_ops_per_frame",
               "host_calls_by_name")},
           # the GN kernel's mean device ms, launched and replayed
           "gn_kernel_ms": both("kernel_ms", "profile"),
           "capture_ms": graph["capture_ms"], "graphs": graph["graphs"],
           "pool_bytes": graph["pool_bytes"]}
    counts_equal = all(graph[k] == eager[k] for k in (
        "gn_launches", "check_crossing_launches", "collectives"))
    row["checks"] = {
        "every_frame_bit_equal": equal == len(eager["poses"]) > 0,
        "same_counts": counts_equal and (graph["gn_launches"] > 0) == kernel,
        "same_fallback_frames": (
            eager["fallback_frames"] is None
            if graph["fallback_frames"] is None
            else np.array_equal(graph["fallback_frames"],
                                eager["fallback_frames"])),
        "overflow_equal": (
            graph["overflow"] == eager["overflow"]
            if isinstance(eager["overflow"], dict)
            else np.array_equal(graph["overflow"], eager["overflow"])),
        "captured": graph["path"] == "graph" and eager["path"] == "eager"
        and None not in graph["capture_ms"],
        # the frame's launches, the GN kernel's among them, are inside
        # the replays
        "gn_launch_inside_the_replay": "cudaLaunchCooperativeKernel"
        not in graph["profile"]["host_calls_by_name"],
        "one_graph_a_static_call": graph["graphs"] != []
        and all(g == 1 for g in graph["graphs"])}
    loops = graph["loop_counts"]
    if loops is not None:
        done, made = loops["gn_loops"], loops["associations"]
        row["checks"].update({
            "same_loops_on_the_same_frames": all(
                loops[k] == eager["loop_counts"][k]
                for k in ("gn_loops", "loop_iterations",
                          "fallback_registrations")) and done > 0,
            "eager_runs_every_trip":
                eager["loop_counts"]["associations"] == trips * done})
        if graph["route"] == "nccl":
            # no IF node (NCCL's collectives cannot live in one): the
            # replay runs every trip, masked, as eager does
            row["checks"].update({
                "no_if_body_in_the_frame": graph["if_bodies"] == 0,
                "replay_runs_every_trip": made == trips * done,
                "loop_collectives_every_trip_replayed":
                    loops["loop_collectives"]
                    == (2 * trips + around) * done})
        else:
            row["checks"]["replay_reassociates_as_the_while_loop"] = (
                made == loops["loop_iterations"] < trips * done)
            if name.startswith("sharded"):
                row["checks"]["loop_collectives_as_the_while_loop"] = (
                    loops["loop_collectives"]
                    == 2 * loops["loop_iterations"] + around * done)
        if name.startswith("sharded"):
            row["checks"]["loop_collectives_every_trip_eager"] = (
                eager["loop_counts"]["loop_collectives"]
                == (2 * trips + around) * done)
        row["reassociations_a_loop"] = {
            k: (r["loop_counts"]["associations"] - done) / done
            for k, r in (("eager", eager), ("graph", graph))}
        row["iterations_a_loop"] = loops["loop_iterations"] / done
        # the full-27 association kernel's launches: eager, issued on the
        # host in the timed run and counted on the device in its second
        # run of the same frames; replayed, counted on the device
        row["nn27_launches"] = {
            "eager_host": eager["nn27_launches"],
            "eager": eager["loop_counts"]["nn27_launches"],
            "graph": loops["nn27_launches"]}
        row["checks"]["nn27_host_count_as_the_device_count"] = (
            eager["nn27_launches"]
            == eager["loop_counts"]["nn27_launches"])
    if quiet:
        row["checks"]["no_host_sync_in_the_frame_loop"] = (
            graph["profile"]["host_syncs_per_frame"] == 0)
    row["checks"] = {k: bool(v) for k, v in row["checks"].items()}
    emit(row)
    if not all(row["checks"].values()):
        raise SystemExit(f"graph_{name} failed: {row['checks']}")
    return {"gn_launches": graph["gn_launches"],
            "check_crossing_launches": graph["check_crossing_launches"],
            "nn27_launches": row.get("nn27_launches"),
            "capture_ms": graph["capture_ms"], "graphs": graph["graphs"],
            "pool_mb": None if graph["pool_bytes"] is None
            else graph["pool_bytes"] / 2**20,
            "collectives_a_frame": graph["collectives"] / count,
            "loop_collectives_a_frame": None if loops is None else {
                k: r["loop_counts"]["loop_collectives"] / count
                for k, r in (("eager", eager), ("graph", graph))},
            **{k: row.get(k) for k in (
                "frames_per_s", "host_calls_per_frame",
                "host_syncs_per_frame", "device_idle_share",
                "reassociations_a_loop", "iterations_a_loop")}}


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

    from kinematic_icp_tpu_torch.ops import cuda_build, nn27
    from kinematic_icp_tpu_torch.utils import cuda_graph, synthetic
    from kinematic_icp_tpu_torch.utils.io import native

    card = nvidia_smi_line()
    emit({"phase": "environment", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # the host C++ (the ingestion library, the baseline) builds beside nvcc
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build, "kicp_io", "kicp_baseline")
        built = cuda_build.build(*KERNEL_SOURCES)
        host_built = host.result()
    emit({"phase": "build_host", "targets": {
        name: {"seconds": b["seconds"], "path": b["path"]}
        for name, b in host_built.items()}})
    spill = {name: spills(b["log"]) for name, b in built.items()}
    emit({"phase": "build", "kernels": {
        name: {"seconds": b["seconds"], "spill_bytes": spill[name],
               "ptxas": [ln.strip() for ln in b["log"].splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, b in built.items()}})
    if any(len(spill[name]) < lines or any(spill[name])
           for name, lines in KERNEL_SOURCES.items()):
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
    batched_kernel, batched_drive, drives = batched_phase(torch, np, seq,
                                                          card)
    batched_exact = batched_exact_phase(torch, np, drives)
    nn27_row = nn27_phase(torch, np, drives)
    peer_row = peer_phase(torch, np)
    _, one_rank = sharded_1rank_phase(torch, np, drives)
    loop_batch_phase(torch, np, drives)
    two_ranks = sharded_2rank_phase(torch, np, one_rank)
    serve_launches = serve_phase(torch, np, seq, main_poses)
    cuda_graph.IF_LAUNCHES = 0
    nn27.LAUNCHES = 0
    graph = graph_phase(torch, np, seq, drives, card)
    if_launches = cuda_graph.IF_LAUNCHES
    # issued eagerly or captured over the graph phase (replays add none)
    nn27_graph_host = nn27.LAUNCHES
    if not if_launches:
        raise SystemExit("graph: no IF node captured on its paths")
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
        "launches_batched_exact": batched_exact["gn_check_crossing_launches"],
        # each path of the graph phase replayed: {GN, check_crossing}
        "launches_graph": {name: [p["gn_launches"],
                                  p["check_crossing_launches"]]
                           for name, p in graph.items()},
        "frames_per_launch_batched": batched_drive["frames_per_launch"],
        "batched_ms": batched_kernel["ms"],
        "batched_bound_ms": batched_kernel["bound_ms"],
        "max_abs_err": main_shape["max_abs_err_pose"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None}, {
        "name": "peer_reduce", "route": "cuda",
        "source": "kinematic_icp_tpu_torch/csrc/peer_reduce.cu",
        # no TPU kernel: JAX's lax.pmin / lax.psum over the map axis
        "replaces": "kinematic_icp_tpu/parallel/sharded.py:80",
        "replaces_also": "kinematic_icp_tpu/parallel/sharded.py:121,134,"
                         "155,251",
        # the two-rank sharded drive on the peer route, rank 0
        "launches": two_ranks["peer_route"]["peer_launches_by_rank"][0],
        "launches_per_frame":
            two_ranks["peer_route"]["peer_launches_per_frame"],
        # every shape bit-equal to the plain version (else the peer phase
        # failed)
        "max_abs_err": 0.0,
        # the path's packed keys at two ranks on this card, and every shape
        "ms": peer_row["ms"]["packed_keys_2_ranks"],
        "plain_ms": peer_row["plain_ms"]["packed_keys_2_ranks"],
        "bound_ms": peer_row["bound_ms"]["packed_keys_2_ranks"],
        "bound_by": "bytes", "library_ms": None,
        "library_note": "NCCL puts no two ranks of one communicator on one "
                        "card; tools/sharded_scaling.py --peer-bench times "
                        "dist.all_reduce across cards",
        "ms_by_shape": peer_row["ms"],
        "plain_ms_by_shape": peer_row["plain_ms"],
        "bound_ms_by_shape": peer_row["bound_ms"]}, {
        "name": "graph_if", "route": "cuda",
        "source": "kinematic_icp_tpu_torch/csrc/graph_if.cu",
        # no TPU kernel: sets an IF node's handle, JAX's device-side
        # lax.cond / lax.while_loop
        "replaces": None,
        # IF nodes captured over the graph phase's paths (each replay runs
        # the kernel of every node its bodies reach)
        "launches": if_launches, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None}, {
        "name": "nn27", "route": "cuda",
        "source": "kinematic_icp_tpu_torch/csrc/nn27.cu",
        # no TPU kernel: XLA's gathers of the full-27 search
        "replaces": None,
        "replaces_also": "kinematic_icp_tpu/ops/hashmap.py:487",
        # the batched exact drive's replays, counted on the device (one a
        # fallback association), and what its run issued on the host
        "launches": batched_exact["nn27_launches"],
        "launches_host": batched_exact["nn27_host_launches"],
        # each path of the graph phase that runs the GN loop: eager (host
        # and device counts) and replayed (device count)
        "launches_graph": {name: p["nn27_launches"]
                           for name, p in graph.items()
                           if p["nn27_launches"] is not None},
        "launches_graph_host": nn27_graph_host,
        # one real fallback association at B = 8, N = 8,192 (the nn27
        # phase): bit-equal on the live queries, so max_abs_err is 0
        "max_abs_err": nn27_row["max_abs_err"],
        "ms": nn27_row["ms"], "plain_ms": nn27_row["plain_ms"],
        "bound_ms": nn27_row["bound_ms"], "bound_by": nn27_row["bound_by"],
        "library_ms": None,
        "library_note": "no library kernel searches this hash map",
        "float64_ms": nn27_row["float64"]["ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(*sys.argv[2:5]))
    sys.exit(main())
