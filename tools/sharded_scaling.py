"""The map-sharded path over every card of one host, one process a card.

Usage (on a machine with CUDA cards; one rank a card, NCCL):

    python3 tools/sharded_scaling.py [--frames 20] [--map-reduce peer nccl]

or, to rehearse the same program on the CPU (gloo, a small drive):

    python3 tools/sharded_scaling.py --device cpu --world 4 [--frames 4] \
        [--map-reduce auto nccl]

The script starts one worker process a rank (each under a wall limit) and
drives ``parallel.BatchedOdometryRunner(mesh=...).run_device`` over
``world`` distinct headline drives of ``chip_smoke.py`` on every (data,
map) mesh of the world: (world, 1), the square-most split, and (1, world),
each mesh once a map-axis route of ``--map-reduce`` (``make_mesh``'s
``map_reduce``: "auto", "peer", "nccl"), the routes in turns (reversed on
every other mesh).  On NCCL that runner replays each rank's frame as a
CUDA graph: on the "peer" route the GN loop's later trips and
re-associations (with their SUMs and MINs over peer memory) inside
conditional nodes; on the "nccl" route NCCL's collectives in the graph
and every trip run, masked.  The same drives then run through
``make_sharded_sequence_runner(eager=True)``, op by op, every trip, and
every rank checks the two bit-equal.  Each rank counts, on the device, the
trips JAX's ``while_loop`` makes (the most GN iterations of its rows a
frame) and the GN loop's collectives (``chip_smoke.device_counts``),
captured and eager: a gated replay issues a SUM a trip and a MIN an
association, 2 trips + 2 a frame with β's and the correspondence count's
SUMs; eager and the "nccl" route 2 ``max_num_iterations`` + 2.  On CUDA
the ranks first reduce ``chip_smoke.peer_shapes`` (one of them beyond a
slot of the peer kernel) over peer memory across the world's processes,
bit-equal to the plain version.  The ranks leave the group with
``parallel.shutdown_distributed`` with the last mesh's runners alive.
Rank 0 then runs the same drives through the unsharded runner's loop
lowering on its own card, the yardstick (the sharded path is that loop
with collectives), at B = world and at B = 1 on each drive alone.  Rank 0
prints the peer check's line, then one JSON line a mesh and route: the
route, wall ms a batched frame captured and eager, aggregate frames/s,
collectives a frame (outside the GN loop on the host, and the loop's on
the device, captured and eager) and trips a frame by rank, whether every
rank's captured poses were bit-equal to its eager ones, its loop's
collectives were its trips' and the ranks of each map group made the same
trips, each drive's ATE and the largest pose difference from the
unsharded run and from the mesh's first route (within 5 mm), the frames
bit-equal to the unsharded run at B = world and to each drive's B = 1
run, and each shard's voxel count; then the unsharded run's line and the
cards' ``nvidia-smi`` name and power limit (the first card's).  It exits
non-zero where a check fails.

Options for a full-width row and for comparing two trees in one call:
``--config stock --batch 8 --meshes 1x4`` runs the stock ``Config``
(``max_source`` 8,192: 65,536 packed keys a MIN at B = 8) over
``headline_drive(0..7)`` on (1, 4) alone (on the CPU the small
configuration stands for both); ``--root DIR`` imports the package from
DIR (a parent commit unpacked there) with this script's own code, so two
trees run the same measurement; ``--save DIR`` writes rank 0's poses of
each row, and ``--against DIR`` holds each row bit for bit to the poses
another run saved there (and fails where they differ).

The peer kernel against NCCL (``--peer-bench``, CUDA only): one process a
card, a peer group over the world (``peer.attach``), and at every
``chip_smoke.peer_shapes`` shape and a ladder of int32 MINs (4,096 to
1,048,576 keys, for the one-shot / two-shot switch) it holds the kernel
and NCCL's ``all_reduce`` to the plain version (the kernel bit for bit)
and times, in turns (forward, then back): the kernel, by each algorithm
forced too (where the tree has ``peer.algorithm``), NCCL's
``dist.all_reduce`` eager and replayed from a captured graph: each rank's
median device ms a reduction (``chip_smoke.reductions_ms``), the slowest
rank's; the plain version on rank 0; the bound (``chip_smoke.peer_bound``:
NVLink or HBM bytes).  ``--peer-bench --one-card`` runs the kernel's
groups of 1, 2 and 4 ranks on one card in one process instead (no NCCL:
it puts no two ranks of a communicator on one card).  A line a shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (this tree's, whatever --root says)

#: a worker's wall limit (s); inside it a collective fails after
#: ``parallel.mesh.TIMEOUT``
WORKER_TIMEOUT_S = 600
#: tests/test_torch_pipeline.py's drive configuration and sensor, for a CPU
#: rehearsal
SMALL = dict(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0, max_probes=4,
             deskew=True)
SMALL_LIDAR = dict(num_beams=256, num_rings=4,
                   ring_angles_deg=(-10.0, -3.0, 0.0, 8.0))


def meshes(world: int):
    """(world, 1), the square-most (data, map) split, (1, world)."""
    split = max(d for d in range(1, int(world ** 0.5) + 1) if world % d == 0)
    return list(dict.fromkeys([(world, 1), (world // split, split),
                               (1, world)]))


def drives(args, batch: int):
    from kinematic_icp_tpu_torch.utils import synthetic

    if args.device == "cpu":
        seqs = [synthetic.make_sequence(
            args.frames, world_seed=s, traj_seed=s + 10, noise_seed=s + 20,
            lidar=synthetic.LidarModel(**SMALL_LIDAR)) for s in range(batch)]
    else:
        if args.frames > chip_smoke.MAIN_FRAMES:
            raise ValueError(f"at most {chip_smoke.MAIN_FRAMES} frames")
        seqs = [chip_smoke.headline_drive(s) for s in range(batch)]
    runs = [{"frames": s["frames"][:args.frames],
             "rel_odometry": s["rel_odometry"][:args.frames]} for s in seqs]
    return runs, seqs[0]["extrinsic"]


def timed(torch, runner, runs, sync):
    """``runner.run_device(runs)``: (poses (B, F, 4, 4), seconds, overflow
    warnings)."""
    import numpy as np

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sync()
        t0 = time.perf_counter()
        poses = np.asarray(runner.run_device(runs))
        sync()
        seconds = time.perf_counter() - t0
    return poses, seconds, [str(w.message) for w in caught
                            if "capacity overflow" in str(w.message)]


def counted(torch, sharded, counts, run):
    """``run()`` with the host collective count and ``counts`` (a
    ``chip_smoke.device_counts`` tensor) set to 0 just before; returns (its
    result, [trips, collectives outside the GN loop on the host, the GN
    loop's collectives on the device])."""
    sharded.COLLECTIVES = 0
    counts.zero_()
    out = run()
    got = dict(zip(chip_smoke.LOOP_COUNTS, counts.tolist()))
    return out, [got["loop_iterations"], sharded.COLLECTIVES,
                 got["loop_collectives"]]


def worker(args):
    import numpy as np
    import torch
    import torch.distributed as dist

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import pad_batch
    from kinematic_icp_tpu_torch.ops import hashmap
    from kinematic_icp_tpu_torch.parallel import (BatchedOdometryRunner,
                                                  initialize_distributed,
                                                  make_mesh, map_route,
                                                  sharded,
                                                  shutdown_distributed)
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    torch.set_num_threads(1 if args.device == "cpu" else 4)
    cfg = Config(**(SMALL if args.device == "cpu" else
                    getattr(chip_smoke, args.config.upper())))
    b = args.batch
    initialize_distributed(f"localhost:{args.port}", args.world, args.rank)
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    runs, ext = drives(args, b)
    warm = [{k: v[:3] for k, v in r.items()} for r in runs]
    dev = "cuda" if args.device == "cuda" else "cpu"
    padded = [torch.from_numpy(a).to(dev) for a in pad_batch(runs, cfg)]
    ext_t = torch.tensor(np.asarray(ext, np.float32), device=dev)
    f = args.frames
    # β's SUM before the first trip (the adaptive regularization) and the
    # correspondence count's after the last
    around = int(cfg.use_adaptive_odometry_regularization) + 1
    rows = []
    # a reduction beyond a slot over peer memory across the processes
    peer_ok = None
    if args.device == "cuda":
        peer_ok = chip_smoke.peer_across_processes(
            torch, np, dist.group.WORLD,
            torch.device("cuda", torch.cuda.current_device()))
    turns = [(data, m, route)
             for i, (data, m) in enumerate(args.meshes or meshes(args.world))
             for route in (args.map_reduce if i % 2 == 0
                           else args.map_reduce[::-1])]
    with chip_smoke.device_counts(torch, dev) as loop_counts:
        try:
            for data, m, asked in turns:
                mesh = make_mesh(data, m, args.device, map_reduce=asked)
                route = map_route(mesh)
                # the warm-up captures the runner's frame on NCCL; the timed
                # run replays it from a fresh state
                runner = BatchedOdometryRunner(cfg, b, mesh=mesh,
                                               extrinsic=ext)
                runner.run_device(warm)
                runner.state = sharded.init_sharded_state(cfg, mesh, b)
                runner.poses = [[] for _ in range(b)]
                (poses, seconds, overflow), graph_counts = counted(
                    torch, sharded, loop_counts,
                    lambda: timed(torch, runner, runs, sync))
                counts = hashmap.num_voxels(runner.state.map).to(
                    torch.int64)
                every = [torch.empty_like(counts)
                         for _ in range(args.world)]
                dist.all_gather(every, counts)
                # the same drives op by op: the baseline a replay is held to
                eager = sharded.make_sharded_sequence_runner(
                    cfg, mesh, runner.stationary_gate, eager=True)
                state = sharded.init_sharded_state(cfg, mesh, b)
                sync()
                t0 = time.perf_counter()
                eager_poses, eager_counts = counted(
                    torch, sharded, loop_counts,
                    lambda: eager(state, *padded[:4], ext_t, padded[4])[1])
                sync()
                eager_s = time.perf_counter() - t0
                eager_poses = eager_poses.cpu().numpy().astype(
                    np.float64)
                # this rank's counts, captured then eager, and whether its
                # replay matched eager: the poses bit for bit, the trips, and
                # the GN loop's collectives 2 trips + 2 a frame captured (on
                # gloo the runner's frame runs eagerly too) and 2
                # max_num_iterations + 2 eager
                every_trip = (2 * cfg.max_num_iterations + around) * f
                captured = all(c.graphs
                               for c in runner._seq_runner.step.calls)
                # on the "nccl" route the replay runs every trip too
                gated = captured and route != "nccl"
                same = np.array_equal(poses,
                                      eager_poses.transpose(1, 0, 2, 3))
                as_trips = (graph_counts[0] == eager_counts[0]
                            and graph_counts[2] == (
                                2 * graph_counts[0] + around * f
                                if gated else every_trip)
                            and eager_counts[2] == every_trip)
                mine = torch.tensor(graph_counts + eager_counts
                                    + [int(same), int(as_trips)],
                                    dtype=torch.int64, device=dev)
                ranks = [torch.empty_like(mine)
                         for _ in range(args.world)]
                dist.all_gather(ranks, mine)
                ranks = [r.tolist() for r in ranks]
                rows.append({"mesh": [data, m], "map_reduce": asked,
                             "route": route, "poses": poses,
                             "seconds": seconds, "eager_seconds": eager_s,
                             "collectives": graph_counts[1],
                             "by_rank": ranks,
                             "captured_bit_equal_to_eager_every_rank": all(
                                 r[-2] for r in ranks),
                             "overflow": overflow,
                             "voxels_by_rank": [c.tolist()
                                                for c in every]})
        finally:
            # with the last mesh's captured runner alive: the helper frees
            # its graphs before NCCL's teardown
            shutdown_distributed()
    if args.rank:
        return 0
    lowering = cfg.replace(gn_backend="torch")
    loop = BatchedOdometryRunner(lowering, b, extrinsic=ext, device=dev)
    loop.run_device(warm)
    loop = BatchedOdometryRunner(lowering, b, extrinsic=ext, device=dev)
    want, want_s, want_overflow = timed(torch, loop, runs, sync)
    # each drive alone, B = 1: a (world, 1) rank's batch
    alone = np.concatenate([np.asarray(BatchedOdometryRunner(
        lowering, 1, extrinsic=ext, device=dev).run_device([r]))
        for r in runs])
    if peer_ok is not None:
        print(json.dumps({"peer_across_processes": {
            "ranks": args.world, "bit_equal_to_plain": peer_ok}}),
            flush=True)
    first = {}
    for row in rows:
        poses = row.pop("poses")
        by_rank = row.pop("by_rank")
        data, m = row["mesh"]
        # the mesh's first route, which the others are held to
        other = first.setdefault((data, m), (row["route"], poses))
        row.update(
            trips_alike_within_each_map_group=all(
                len({by_rank[d * m + j][0] for j in range(m)}) == 1
                for d in range(data)),
            vs_route=other[0],
            ate_vs_route_m=[ate_rmse(other[1][i], poses[i], align=False)
                            for i in range(b)],
            max_abs_vs_route=float(np.abs(poses - other[1]).max()),
            trips_a_frame_by_rank=[r[0] / f for r in by_rank],
            loop_collectives_a_frame_by_rank={
                "graph": [r[2] / f for r in by_rank],
                "eager": [r[5] / f for r in by_rank]},
            loop_collectives_as_the_trips_every_rank=all(
                r[-1] for r in by_rank),
            ms_per_batched_frame=row["seconds"] * 1e3 / f,
            aggregate_frames_per_s=b * f / row["seconds"],
            collectives_per_frame=row.pop("collectives") / f,
            ate_vs_unsharded_m=[ate_rmse(want[i], poses[i], align=False)
                                for i in range(b)],
            max_abs_vs_unsharded=float(np.abs(poses - want).max()),
            frames_bit_equal_to_unsharded=sum(
                bool(np.array_equal(poses[:, k], want[:, k]))
                for k in range(f)),
            frames_bit_equal_to_b1_loop_by_drive=[
                sum(bool(np.array_equal(poses[i, k], alone[i, k]))
                    for k in range(f)) for i in range(b)],
            max_abs_vs_b1_loop=float(np.abs(poses - alone).max()),
            eager_ms_per_batched_frame=row.pop("eager_seconds") * 1e3 / f)
        name = f"{data}x{m}_{row['route']}.npy"
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            np.save(os.path.join(args.save, name), poses)
        if args.against:
            row["bit_equal_to_against"] = bool(np.array_equal(
                poses, np.load(os.path.join(args.against, name))))
        print(json.dumps({"sharded": row, "world": args.world, "B": b,
                          "config": args.config, "root": args.root,
                          "device": args.device, "frames": f}), flush=True)
    print(json.dumps({"unsharded_loop": {
        "B": b, "frames": f, "seconds": want_s,
        "ms_per_batched_frame": want_s * 1e3 / f,
        "aggregate_frames_per_s": b * f / want_s,
        "overflow": want_overflow,
        "frames_bit_equal_to_b1_loop_by_drive": [
            sum(bool(np.array_equal(want[i, k], alone[i, k]))
                for k in range(f)) for i in range(b)]}}),
        flush=True)
    return 0 if peer_ok is not False and all(
        r.get("bit_equal_to_against", True)
        and r["captured_bit_equal_to_eager_every_rank"]
        and r["loop_collectives_as_the_trips_every_rank"]
        and r["trips_alike_within_each_map_group"]
        and max(r["ate_vs_route_m"]) < 5e-3 for r in rows) else 1


#: int32 MINs of a ladder of sizes (keys) beside ``peer_shapes`` in the
#: peer bench, for the one-shot / two-shot switch
LADDER = (4096, 16384, 65536, 131072, 262144, 524288, 1048576)
#: the peer bench's runs a measurement, and calls a run between two events
BENCH_RUNS = 10
BENCH_CALLS = 20


def bench_shapes(torch):
    """``chip_smoke.peer_shapes`` and the LADDER's int32 MINs, by name."""
    import torch.distributed as dist

    shapes = dict(chip_smoke.peer_shapes(torch))
    shapes.update({f"ladder_{n}": (torch.int32, dist.ReduceOp.MIN, n)
                   for n in LADDER})
    return shapes


def in_turns(torch, peer, timed, streams=()):
    """Each of ``timed`` (name: a call that issues one reduction on each of
    ``streams``, or on the current stream) timed by
    ``chip_smoke.reductions_ms`` in turns, forward then back: {name: [ms,
    ms]}.  "one_shot" and "two_shot" run with ``peer.algorithm`` forced to
    them."""
    got = {name: [] for name in timed}
    own = getattr(peer, "algorithm", None)
    for name in list(timed) + list(timed)[::-1]:
        if name in ("one_shot", "two_shot"):
            peer.algorithm = lambda nbytes, m, name=name: name
        try:
            got[name].append(chip_smoke.reductions_ms(
                torch, timed[name], streams, BENCH_RUNS, BENCH_CALLS))
        finally:
            if own is not None:
                peer.algorithm = own
    return got


def kernel_variants(peer, launch):
    """The kernel's timed calls: by the tree's own choice, and by each
    algorithm forced where the tree has them (``in_turns``)."""
    timed = {"kernel": launch}
    if hasattr(peer, "algorithm"):
        timed.update(one_shot=launch, two_shot=launch)
    return timed


def peer_line(peer, name, dtype, op, n, ranks, cards, grid):
    """The fields of a peer bench line that the shape fixes."""
    import torch

    nbytes = n * torch.empty((), dtype=dtype).element_size()
    bound, by = chip_smoke.peer_bound(nbytes, ranks, cards)
    line = {"peer_bench": name, "dtype": str(dtype), "op": str(op), "n": n,
            "bytes": nbytes, "ranks": ranks, "cards": cards,
            "bound_ms": bound, "bound_by": f"bytes ({by})", "grid": grid}
    if hasattr(peer, "algorithm"):
        line["algorithm"] = peer.algorithm(min(nbytes, peer.SLOT_BYTES),
                                           ranks)
    return line


def peer_bench_one_card(args):
    """The kernel's groups of 1, 2 and 4 ranks on one card, one process
    (``peer.local_groups``, a stream a rank), at ``bench_shapes``: bits
    against the plain version, ms in turns, the plain version's ms and the
    bound; a line a shape.  Returns whether every reduction matched."""
    import numpy as np
    import torch

    from kinematic_icp_tpu_torch.parallel import peer

    dev = torch.device("cuda", 0)
    ok = True
    for size in (1, 2, 4):
        groups = peer.local_groups(dev, size)
        streams = [torch.cuda.Stream(dev) for _ in range(size)]
        try:
            for k, (name, (dtype, op, n)) in enumerate(
                    bench_shapes(torch).items()):
                parts = chip_smoke.peer_parts(
                    torch, np, np.random.default_rng([size, k]), dtype, n,
                    size, dev)
                want = peer.reference(parts, op)
                got = [p.clone() for p in parts]

                def launch():
                    for g, st, t in zip(groups, streams, got):
                        with torch.cuda.stream(st):
                            g.all_reduce(t, op)

                torch.cuda.synchronize()
                launch()
                torch.cuda.synchronize()
                equal = all(chip_smoke.bits_equal(torch, t, want)
                            for t in got)
                ok &= equal
                line = peer_line(peer, name, dtype, op, n, size, 1,
                                 getattr(groups[0], "grid", 1))
                line.update(
                    ms=in_turns(torch, peer, kernel_variants(peer, launch),
                                streams),
                    plain_ms=chip_smoke.median_ms(
                        lambda: peer.reference(parts, op)),
                    kernel_bit_equal=equal, root=args.root)
                print(json.dumps(line), flush=True)
        finally:
            torch.cuda.synchronize()
            for g in groups:
                g.free()
    return ok


def peer_bench_shape(args, peer, mine, group, k, name, dtype, op, n):
    """One shape of the peer bench across the world's processes: the kernel
    and NCCL's ``all_reduce`` (eager and a captured graph's replay) held
    to the plain version and timed in turns; rank 0's line (the slowest
    rank's ms) or None.  Returns (line, whether the kernel matched on
    every rank)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    dev = mine.device
    m, rank = args.world, args.rank
    parts = chip_smoke.peer_parts(torch, np, np.random.default_rng([k]),
                                  dtype, n, m, dev)
    want = peer.reference(parts, op)
    got, nccl = parts[rank].clone(), parts[rank].clone()
    mine.all_reduce(got, op)
    dist.all_reduce(nccl, op=op, group=group)
    torch.cuda.synchronize()
    equal = [chip_smoke.bits_equal(torch, got, want),
             chip_smoke.bits_equal(torch, nccl, want)]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            dist.all_reduce(nccl, op=op, group=group)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    timed = kernel_variants(peer, lambda: mine.all_reduce(got, op))
    timed.update(nccl=lambda: dist.all_reduce(nccl, op=op, group=group),
                 nccl_graph=graph.replay)
    ms = in_turns(torch, peer, timed)
    plain = (chip_smoke.median_ms(lambda: peer.reference(parts, op))
             if rank == 0 else None)
    every = [None] * m
    dist.all_gather_object(every, (equal, ms), group=group)
    torch.cuda.synchronize()
    del graph, timed
    matched = all(e[0][0] for e in every)
    if rank:
        return None, matched
    line = peer_line(peer, name, dtype, op, n, m, m,
                     getattr(mine, "grid", 1))
    line.update(
        ms={key: [max(e[1][key][i] for e in every) for i in range(2)]
            for key in ms},
        ms_by_rank={key: [e[1][key] for e in every] for key in ms},
        plain_ms=plain, kernel_bit_equal_every_rank=matched,
        nccl_bit_equal_every_rank=all(e[0][1] for e in every),
        root=args.root)
    return line, matched


def peer_bench_worker(args):
    """One rank of ``--peer-bench`` across the world's cards (NCCL, one
    process a card): a peer group over the world, every ``bench_shapes``
    shape (``peer_bench_shape``); rank 0 prints a line a shape."""
    import torch
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import initialize_distributed, peer

    initialize_distributed(f"localhost:{args.port}", args.world, args.rank)
    group = dist.group.WORLD
    mine = peer.attach(group, torch.device("cuda",
                                           torch.cuda.current_device()))
    ok = True
    try:
        for k, (name, (dtype, op, n)) in enumerate(
                bench_shapes(torch).items()):
            line, matched = peer_bench_shape(args, peer, mine, group, k,
                                             name, dtype, op, n)
            ok &= matched
            if line is not None:
                print(json.dumps(line), flush=True)
    finally:
        torch.cuda.synchronize()
        dist.barrier(group)
        mine.close()
        dist.barrier(group)
        mine.free()
        dist.destroy_process_group()
    return 0 if ok else 1


def mesh_shape(text):
    """A (data, map) mesh from "DxM"."""
    data, m = text.lower().split("x")
    return int(data), int(m)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks (default: every CUDA card)")
    ap.add_argument("--map-reduce", nargs="+", default=["auto"],
                    choices=("auto", "peer", "nccl"),
                    help="the map-axis routes each mesh runs, in turns")
    ap.add_argument("--config", choices=("headline", "stock"),
                    default="headline",
                    help="chip_smoke's configuration on the card (the "
                         "small one on the CPU)")
    ap.add_argument("--batch", type=int, default=0,
                    help="sequences (default: the world)")
    ap.add_argument("--meshes", nargs="+", type=mesh_shape, default=None,
                    help="(data, map) meshes as DxM (default: (world, 1), "
                         "the square-most, (1, world))")
    ap.add_argument("--root", default=None,
                    help="import the package from this tree instead")
    ap.add_argument("--save", default=None,
                    help="write rank 0's poses of each row here")
    ap.add_argument("--against", default=None,
                    help="hold each row bit for bit to the poses saved here")
    ap.add_argument("--peer-bench", action="store_true",
                    help="the peer kernel against NCCL's all_reduce")
    ap.add_argument("--one-card", action="store_true",
                    help="with --peer-bench: groups of 1, 2, 4 ranks on "
                         "one card")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.rank >= 0:
        return peer_bench_worker(args) if args.peer_bench else worker(args)

    import socket

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("sharded_scaling: no CUDA card", file=sys.stderr)
            return 1
        args.world = args.world or torch.cuda.device_count()
    elif args.peer_bench:
        ap.error("--peer-bench needs CUDA cards")
    if args.peer_bench and args.one_card:
        ok = peer_bench_one_card(args)
        print(chip_smoke.nvidia_smi_line(), flush=True)
        return 0 if ok else 1
    if args.world < 1:
        ap.error("--world is needed on the CPU")
    args.batch = args.batch or args.world
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    base = [sys.executable, os.path.abspath(__file__), "--frames",
            str(args.frames), "--device", args.device, "--world",
            str(args.world), "--port", str(port), "--map-reduce",
            *args.map_reduce, "--config", args.config, "--batch",
            str(args.batch)]
    if args.meshes:
        base += ["--meshes", *(f"{d}x{m}" for d, m in args.meshes)]
    for flag in ("root", "save", "against"):
        if getattr(args, flag):
            base += [f"--{flag}", os.path.abspath(getattr(args, flag))]
    if args.peer_bench:
        base.append("--peer-bench")
    procs = [subprocess.Popen(
        base + ["--rank", str(r)],
        stdout=None if r == 0 else subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(args.world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[1])
    except subprocess.TimeoutExpired:
        print(f"sharded_scaling: a worker ran past {WORKER_TIMEOUT_S} s",
              file=sys.stderr)
        return 1
    finally:
        for p in procs:
            p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    for r in bad:
        print(f"rank {r} exit {procs[r].returncode}:\n{errs[r][-3000:]}",
              file=sys.stderr)
    if args.device == "cuda":
        print(chip_smoke.nvidia_smi_line(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
