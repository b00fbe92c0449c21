"""Port vs JAX: map sharding on ``torch.distributed``.

The ownership hash and the packed-key combine against JAX's under
``shard_map`` on the 8-device CPU mesh; a one-rank gloo group in this
process against the port's unsharded runner; four gloo worker processes on
a (data, map) = (2, 2) mesh against JAX's sharded step and runner on the
same mesh shape, and, with the GN loop's trips and re-associations skipped
as a captured frame's IF nodes skip them, against the always-run loop and
JAX's sharded ``while_loop``; and the three faults of JAX's sharded path
the port does not copy, one test each.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu.ops import voxel as jvox
from kinematic_icp_tpu.parallel import init_sharded_state as j_init
from kinematic_icp_tpu.parallel import make_mesh as j_mesh
from kinematic_icp_tpu.parallel import make_sharded_step as j_step
from kinematic_icp_tpu.parallel import sharded as jsharded
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.convert import (sharded_state_from_jax,
                                             sharded_state_to_jax)
from kinematic_icp_tpu_torch.models import pipeline
from kinematic_icp_tpu_torch.oracle.reference import se3_log
from kinematic_icp_tpu_torch.ops import hashmap as thm
from kinematic_icp_tpu_torch.ops import voxel as tvox
from kinematic_icp_tpu_torch.parallel import (BatchedOdometryRunner,
                                              make_mesh, sharded)
from kinematic_icp_tpu_torch.utils import profiling, synthetic

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
#: tests/test_parallel.py:20-22
CFG = JConfig(max_points=4096, max_downsampled=4096, max_source=2048,
              map_capacity=1 << 13, voxel_size=1.0, max_range=60.0,
              deskew=True)
#: tests/test_torch_pipeline.py's drive configuration and sensor, for the
#: one-rank tests
SMALL = JConfig(max_points=1024, max_downsampled=1024, max_source=512,
                map_capacity=4096, voxel_size=1.0, max_range=15.0,
                max_probes=4, deskew=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
NUM_FRAMES = 8
#: the frames JAX's step runs before the one the workers take from its
#: state
PREFIX = 3
#: the ragged sequence's length
SHORT = NUM_FRAMES - 3
#: the 4 workers' wall limit (inside them a collective fails after
#: ``parallel.mesh.TIMEOUT``, 120 s)
WORKER_TIMEOUT_S = 240


def _port_cfg(jcfg, **kw):
    return Config.from_dict(dataclasses.asdict(jcfg)).replace(**kw)


def _drives(**kw):
    """tests/test_parallel.py's two drives."""
    return [synthetic.make_sequence(NUM_FRAMES, world_seed=s,
                                    traj_seed=s + 10, noise_seed=s + 20, **kw)
            for s in range(2)]


def _runs(seqs):
    return [{"frames": s["frames"], "rel_odometry": s["rel_odometry"]}
            for s in seqs]


@pytest.fixture(scope="module")
def sequences():
    return _drives()


@pytest.fixture(scope="module")
def small_sequences():
    return _drives(lidar=synthetic.LidarModel(**LIDAR))


# --- the ops ---------------------------------------------------------------

def _coords(rng, n=4000):
    c = rng.integers(-2**31, 2**31, (n, 3), dtype=np.int64).astype(np.int32)
    c[:1000] = rng.integers(-70, 70, (1000, 3))  # a map's range
    c[1000:1006] = [[-1, -1, -1], [0, 0, 0], [2**31 - 1] * 3, [-2**31] * 3,
                    [-2**31, 2**31 - 1, 0], [1, -1, 7]]
    return c


def test_spatial_hash_bit_equal():
    c = _coords(np.random.default_rng(0))
    want = np.asarray(jvox.spatial_hash(jnp.asarray(c)))
    got = tvox.spatial_hash(torch.from_numpy(c))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    planes = [torch.from_numpy(np.ascontiguousarray(c[:, i]))
              for i in range(3)]
    assert torch.equal(tvox.spatial_hash_planar(*planes), got)
    pts = np.random.default_rng(1).uniform(-50, 50, (500, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tvox.voxel_coords(torch.from_numpy(pts), 0.5).numpy(),
        np.asarray(jvox.voxel_coords(jnp.asarray(pts), 0.5)))


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_owner_of_bit_equal(m):
    c = _coords(np.random.default_rng(2))
    want = np.asarray(jsharded._owner_of(*(jnp.asarray(c[:, i])
                                           for i in range(3)), m))
    got = sharded._owner_of(*(torch.from_numpy(np.ascontiguousarray(
        c[:, i])) for i in range(3)), m).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < m
    assert m == 1 or len(np.unique(got)) == m


@pytest.mark.parametrize("m", [2, 4, 8])
def test_shard_keys_min_matches_pmin(m):
    """Each shard's kept pairs after the combine: the port's keys and their
    minimum against JAX's ``pmin`` under ``shard_map``."""
    rng = np.random.default_rng(3 + m)
    n = 700
    d = rng.uniform(0, 2.0, (m, n)).astype(np.float32)
    d[:, :50] = np.inf                                  # no candidate
    d[:, 50:100] = d[:1, 50:100]                        # exact ties
    d[1:, 100:150] = np.nextafter(d[:1, 100:150], 9.0)  # 1-ulp near-ties
    d[rng.uniform(size=(m, n)) < 0.2] = np.inf
    mask = rng.uniform(size=n) < 0.9
    tau = np.float32(1.5)
    mesh = j_mesh(data=1, map=m, devices=jax.devices()[:m])
    from jax.sharding import PartitionSpec as P

    def combine(dist_):
        dummy = jnp.zeros(dist_.shape[-1])
        return jsharded._combine_local_nn(dummy, dist_[0], jnp.asarray(mask),
                                          tau, "map")[1][None]

    want = np.asarray(jax.jit(jax.shard_map(
        combine, mesh=mesh, in_specs=P("map"), out_specs=P("map")))(
            jnp.asarray(d)))
    keys = torch.stack([sharded.shard_keys(torch.from_numpy(d[j]), j)
                        for j in range(m)])
    assert keys.dtype == torch.int32
    mine = keys == keys.amin(0)
    got = torch.from_numpy(mask) & (torch.from_numpy(d) < float(tau)) & mine
    np.testing.assert_array_equal(got.numpy(), want)
    # every query with a candidate within tau is kept by exactly one shard
    within = mask & (d < tau).any(0)
    np.testing.assert_array_equal(got.numpy().sum(0), within.astype(int))


# --- one rank in this process ----------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, 1, CPU)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("exact", [False, True], ids=["cached", "exact"])
def test_one_rank_mesh_bit_equal_to_unsharded_loop(one_rank, small_sequences,
                                                   exact, monkeypatch):
    """A (1, 1) mesh runs the unsharded loop lowering's ops, so its
    poses are its bits, through ``run_device`` and ``run`` alike; the map
    ends bit-equal too.  The exact mode with ``neighbor_candidates=10``
    re-gathers all 27 voxels, as the unsharded full-27 loop does (the
    second JAX fault not copied: JAX's sharded exact mode gathers 10).
    The mesh's ``run_device`` streams its frames through the ring as the
    unsharded one does (one ``kicp.pad_batch`` span a batched frame inside
    ``kicp.frames``, and the ``stream`` count), and its sequence runner's
    ``fallbacks`` are its counts' ``exact_fallback_frames`` column."""
    kw = dict(exact_gn_reassociation=True, neighbor_candidates=10) \
        if exact else {}
    cfg = _port_cfg(SMALL, gn_backend="torch", **kw)
    # the full-27 loop is the slow one on a CPU: half the frames
    frames = NUM_FRAMES // 2 if exact else NUM_FRAMES
    runs = [{k: v[:frames] for k, v in r.items()}
            for r in _runs(small_sequences)]
    plain = BatchedOdometryRunner(cfg, 2, device=CPU)
    want = plain.run_device(runs)
    returned = []
    make = sharded.make_sharded_sequence_runner

    def kept(*args, **kwargs):
        run = make(*args, **kwargs)

        def recorded(*inputs):
            returned.append(run(*inputs))
            return returned[-1]

        return recorded

    monkeypatch.setattr(sharded, "make_sharded_sequence_runner", kept)
    device = BatchedOdometryRunner(cfg, 2, mesh=one_rank)
    profiling._buffer.clear()
    with profiling.recording():
        got = device.run_device(runs)
    spans = {}
    for name, start, v in profiling._buffer:
        if "end_ns" in v:
            spans.setdefault(name, []).append((start, v["end_ns"]))
    (outer,) = spans["kicp.frames"]
    inside = [s for s in spans["kicp.pad_batch"]
              if outer[0] <= s[0] and s[1] <= outer[1]]
    assert len(inside) == len(spans["kicp.pad_batch"]) == frames
    assert [v for _, v in profiling.samples("stream")] == [
        {"frames": frames, "waits": 0}]
    profiling._buffer.clear()
    (_, _, _, fallbacks, counts), = returned
    column = pipeline.COUNTS.index("exact_fallback_frames")
    assert torch.equal(fallbacks, counts[:, column])
    np.testing.assert_array_equal(device.stats["exact_fallback_frames"],
                                  fallbacks.numpy())
    stepped = BatchedOdometryRunner(cfg, 2, mesh=one_rank).run(runs)
    for i in range(2):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]))
        np.testing.assert_array_equal(np.asarray(stepped[i]),
                                      np.asarray(want[i]))
    assert torch.equal(device.state.map.table, plain.state.map.table)


def test_exact_mode_gathers_all_27_voxels(one_rank, small_sequences,
                                          monkeypatch):
    """The second JAX fault, pinned at the gather: every association of the
    sharded exact mode asks for 27 voxels under ``neighbor_candidates=10``."""
    asked = []
    gather = thm.gather_candidates

    def spy(m, q, voxel_size, max_probes, num_candidate_voxels=27, **kw):
        asked.append(num_candidate_voxels)
        return gather(m, q, voxel_size, max_probes, num_candidate_voxels,
                      **kw)

    monkeypatch.setattr(thm, "gather_candidates", spy)
    cfg = _port_cfg(SMALL, exact_gn_reassociation=True,
                    neighbor_candidates=10)
    BatchedOdometryRunner(cfg, 1, mesh=one_rank).run(
        _runs(small_sequences[:1]))
    assert asked and set(asked) == {27}


def test_sharded_runner_honours_stationary_gate(one_rank, small_sequences):
    """The third JAX fault: ``run_device`` on a mesh gates at the runner's
    ``stationary_gate`` (JAX's sharded runner fixes 1e-3), as ``run``
    does."""
    runs = _runs(small_sequences[:1])
    norms = np.array([np.linalg.norm(se3_log(np.asarray(r, np.float64)))
                      for r in runs[0]["rel_odometry"]])
    s = np.sort(norms[norms > 1e-3])
    i = int(np.argmax(np.diff(s)[1:-1])) + 1  # a gap among the middle
    gate = float(0.5 * (s[i] + s[i + 1]))
    cfg = _port_cfg(SMALL)
    for how in ("run", "run_device"):
        runner = BatchedOdometryRunner(cfg, 1, mesh=one_rank,
                                       stationary_gate=gate)
        poses = np.asarray(getattr(runner, how)(runs)[0])
        prev = np.concatenate([np.eye(4)[None], poses[:-1]])
        moved = np.abs(poses - prev).max(axis=(1, 2)) > 0
        np.testing.assert_array_equal(moved, norms > gate, err_msg=how)
        assert moved.any() and (norms[~moved] > 1e-3).any()


def test_sharded_downsample_honours_tiebreak(one_rank, sequences):
    """The first JAX fault: at a width where the packed-word downsample
    engages (32,768 points a frame), ``downsample_tiebreak="min"`` picks
    other representatives than "first".  The port's sharded runner honours
    it (bit-equal to its unsharded loop under "min", apart from its own
    "first"); JAX's sharded runner runs "first" under "min": within 1e-5
    of the port's "first" and not of its "min"."""
    wide = CFG.replace(max_points=32768, downsample_tiebreak="min")
    arrays = toffline.pad_batch(sequences[:1], _port_cfg(wide))
    frames = 3

    def port(mesh, **kw):
        cfg = _port_cfg(wide, gn_backend="torch", **kw)
        if mesh is None:
            run = toffline.make_batched_sequence_runner(cfg, CPU)
            state = toffline.init_batched_state(cfg, 1, device=CPU)
        else:
            run = sharded.make_sharded_sequence_runner(cfg, mesh)
            state = sharded.init_sharded_state(cfg, mesh, 1)
        out = run(state, *(torch.from_numpy(a[:frames]) for a in arrays[:4]),
                  torch.eye(4), torch.from_numpy(arrays[4][:frames]))
        return out[1].numpy()

    got_min = port(one_rank)
    np.testing.assert_array_equal(got_min, port(None))
    got_first = port(one_rank, downsample_tiebreak="first")
    apart = np.abs(got_min - got_first).max()
    mesh = j_mesh(data=1, map=1, devices=jax.devices()[:1])
    run = jsharded.make_sharded_sequence_runner(wide, mesh, donate=False)
    _, jposes, _ = run(j_init(wide, mesh, 1),
                       *(jnp.asarray(a[:frames]) for a in arrays[:4]),
                       jnp.eye(4), jnp.asarray(arrays[4][:frames]))
    jposes = np.asarray(jposes)
    assert np.abs(jposes - got_first).max() < 1e-5
    assert apart > 1e-4 and np.abs(jposes - got_min).max() > 1e-4


def test_nccl_route_keeps_the_loop_collectives_out_of_if_bodies(
        one_rank, small_sequences, monkeypatch):
    """With ``cuda_graph.when`` doing what a captured IF node does (the
    body only where its predicate is set) and every map-axis reduction
    recorded with the number of bodies around it: on the "nccl" route no
    reduction sits inside a body and every trip issues its own (β's SUM,
    a SUM a trip, a MIN a re-association, the correspondence count's SUM
    and the insert failures' SUM: 2 x 10 + 3 a frame); on the "peer"
    route the later trips' reductions sit inside bodies, and fewer run.
    The poses are the same bits on both routes."""
    from kinematic_icp_tpu_torch.utils import cuda_graph

    cfg = _port_cfg(SMALL, gn_backend="torch")
    frames = 3
    packed = [torch.from_numpy(a[:frames]) for a in toffline.pad_batch(
        _runs(small_sequences[:1]), cfg)]
    depth, issued = [0], []

    def if_node(pred, body):
        depth[0] += 1
        try:
            if bool(pred):
                body()
        finally:
            depth[0] -= 1

    def recorded(t, op, axes):
        issued[-1].append(depth[0])
        return t

    monkeypatch.setattr(cuda_graph, "when", if_node)
    monkeypatch.setattr(sharded, "_all_reduce", recorded)
    routes = {}
    for route in ("nccl", "peer"):
        axes = sharded._axes(one_rank)._replace(route=route)
        monkeypatch.setattr(sharded, "_axes", lambda mesh: axes)
        state = sharded.init_sharded_state(cfg, one_rank, 1)
        poses, counts = [], []
        for f in range(frames):
            issued.append([])
            state, out = sharded.sharded_register_frame(
                state, *(a[f] for a in packed[:4]), torch.eye(4),
                packed[4][f], cfg, one_rank,
                active=torch.ones(1, dtype=torch.bool))
            poses.append(out.pose.clone())
            counts.append(issued[-1])
        routes[route] = torch.stack(poses), counts
    every_trip = 2 * cfg.max_num_iterations + 3
    nccl, peer = routes["nccl"][1], routes["peer"][1]
    assert all(c == [0] * every_trip for c in nccl)
    assert any(max(c) > 0 for c in peer)
    assert all(len(c) < every_trip for c in peer)
    assert torch.equal(routes["nccl"][0], routes["peer"][0])


def test_mesh_checks_its_shape(one_rank):
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(2, 1, CPU)
    with pytest.raises(ValueError, match="divide"):
        make_mesh(map=3, device_type=CPU)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, 1)
    assert make_mesh(map=1, device_type=CPU).shape == (1, 1)
    cfg = _port_cfg(CFG)
    state = sharded.init_sharded_state(cfg, one_rank, 3)
    assert state.map.table.shape == (3, CFG.map_capacity // CFG.max_probes,
                                     CFG.max_probes * 24)
    with pytest.raises(ValueError, match="3 sequences"):
        sharded.make_sharded_step(cfg, one_rank)(
            sharded.init_sharded_state(cfg, one_rank, 2),
            *(torch.zeros(3, 4096, 3), torch.zeros(3, 4096),
              torch.zeros(3, 4096, dtype=torch.bool),
              torch.zeros(3, dtype=torch.bool), torch.eye(4),
              torch.eye(4).expand(3, 4, 4), torch.ones(3, dtype=torch.bool)))


# --- four gloo workers on a (2, 2) mesh ------------------------------------

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch.convert import (
    sharded_state_from_jax, state_from_numpy, state_to_numpy)
from kinematic_icp_tpu_torch.models import pipeline
from kinematic_icp_tpu_torch.parallel import (
    BatchedOdometryRunner, initialize_distributed, make_mesh,
    make_sharded_step, sharded)
from kinematic_icp_tpu_torch.utils import synthetic

out_dir, rank = sys.argv[1], int(os.environ["RANK"])
initialize_distributed()  # torchrun's environment
mesh = make_mesh(2, 2, "cpu")
inp = np.load(os.path.join(out_dir, "inputs.npz"))
with open(os.path.join(out_dir, "config.json")) as f:
    cfg = Config(**json.load(f))
t = lambda a: torch.from_numpy(np.asarray(a))
res = {}

# 1. one step from JAX's state of the whole batch
local = state_from_numpy(
    *sharded_state_from_jax([inp["s_" + k] for k in "ptos"], 2, 2, rank),
    bucket_slots=cfg.max_probes, device="cpu")
step_in = [t(inp["x_" + k]) for k in ("pts", "ts", "mask", "has_ts")]
ext, rel, active = torch.eye(4), t(inp["x_rel"]), t(inp["x_active"])
new, poses, overflow = make_sharded_step(cfg, mesh)(
    local, *step_in, ext, rel, active)
res["step_poses"], res["step_overflow"] = poses.numpy(), overflow.numpy()
res["step_table"] = state_to_numpy(new)[1]
#    the ownership-filtered insert and evict given JAX's new pose
axes = sharded._axes(mesh)
rows = sharded._rows(axes, local, 2)
prep = pipeline.prepare_frame(local, *(x[rows] for x in step_in), ext,
                              rel[rows], cfg)
m, _ = sharded._update_shard(local.map, prep.frame_ds, prep.frame_ds_mask,
                             t(inp["x_jax_pose"])[rows], cfg, axes,
                             active[rows])
res["given_pose_table"] = m.table.numpy().view(np.uint32)

# 2. the 8-frame drives, the second cut short, through the sequence runner
#    (run_device) and a step a frame (run), from a fresh state
seqs = [synthetic.make_sequence(int(inp["frames"]), world_seed=s,
                                traj_seed=s + 10, noise_seed=s + 20)
        for s in range(2)]
short = int(inp["short"])
ragged = [{"frames": s["frames"], "rel_odometry": s["rel_odometry"]}
          for s in seqs]
ragged[1] = {k: v[:short] for k, v in ragged[1].items()}
for how in ("run", "run_device"):
    runner = BatchedOdometryRunner(cfg, 2, mesh=mesh)
    got = getattr(runner, how)(ragged)
    for i in range(2):
        res[f"{how}_{i}"] = np.asarray(got[i])
for k, v in zip("ptos", state_to_numpy(runner.state)):
    res["run_state_" + k] = v
#    the eager frame loop (sharded_register_frame op by op) over the same
#    padded drives, against run_device's buffered step
from kinematic_icp_tpu_torch.offline import pad_batch
packed = [t(a) for a in pad_batch(ragged, cfg)]
eager = sharded.make_sharded_sequence_runner(cfg, mesh, eager=True)(
    sharded.init_sharded_state(cfg, mesh, 2), *packed[:4], torch.eye(4),
    packed[4])
res["eager_poses"] = eager[1].numpy()
for k, v in zip("ptos", state_to_numpy(eager[0])):
    res["eager_state_" + k] = v

# 3. run_device again with cuda_graph.when patched to what a captured IF
#    node does (read the predicate back, run the body only where it is
#    set); each frame's GN loop records its gates' decisions in order, its
#    trips, its associations and its rows' iterations
from kinematic_icp_tpu_torch.ops import registration
from kinematic_icp_tpu_torch.utils import cuda_graph
loops = []
run_gn, normal = registration.run_gn, registration.partial_normal_equations

def if_node(pred, body):
    loops[-1]["decisions"].append(bool(pred))
    if loops[-1]["decisions"][-1]:
        body()

def tripped(*a):
    loops[-1]["trips"] += 1
    return normal(*a)

def recorded(associate, *a, **kw):
    loop = {"decisions": [], "trips": 0, "associations": 0}
    loops.append(loop)
    def counted(pose):
        loop["associations"] += 1
        return associate(pose)
    out = run_gn(counted, *a, **kw)
    loop["iterations"] = out[1].reshape(-1).tolist()
    return out

cuda_graph.when, registration.run_gn = if_node, recorded
registration.partial_normal_equations = tripped
gated = BatchedOdometryRunner(cfg, 2, mesh=mesh).run_device(ragged)
for i in range(2):
    res[f"gated_{i}"] = np.asarray(gated[i])
with open(os.path.join(out_dir, f"loops_{rank}.json"), "w") as f:
    json.dump(loops, f)
np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **res)
torch.distributed.destroy_process_group()
print(f"rank {rank}: OK", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_step():
    """JAX's sharded step on a (2, 2) mesh: (mesh, step)."""
    mesh = j_mesh(data=2, map=2, devices=jax.devices()[:4])
    return mesh, j_step(CFG, mesh, donate=False)


def _active(sequences):
    """(F, B) JAX's stationary gate on each frame's odometry."""
    norms = np.linalg.norm(np.stack([[se3_log(np.asarray(r, np.float64))
                                      for r in s["rel_odometry"]]
                                     for s in sequences], axis=1), axis=-1)
    return norms > 1e-3


def _jax_iterations(mesh, step, packed, active):
    """(F, B) the GN iterations of JAX's sharded step over the padded
    drives ``packed`` from a fresh state: under ``vmap`` its ``while_loop``
    makes a rank's most iterations of a row of trips."""
    state, its = j_init(CFG, mesh, 2), []
    for f in range(len(active)):
        state, out = step(state, *(jnp.asarray(a[f]) for a in packed[:4]),
                          jnp.eye(4), jnp.asarray(packed[4][f]),
                          jnp.asarray(active[f]))
        its.append(np.asarray(out.debug.iterations))
    return np.stack(its)


def _jax_inputs(sequences, mesh, step):
    """JAX's sharded step over the first PREFIX frames, then one more
    step: the state before it, its inputs and its outputs."""
    packed = toffline.pad_batch(sequences, _port_cfg(CFG))
    active = _active(sequences)
    state = j_init(CFG, mesh, 2)
    for f in range(PREFIX + 1):
        if f == PREFIX:
            before = [np.asarray(a) for a in (
                state.pose, state.map.table, state.threshold.odom_sse,
                state.threshold.num_samples)]
        state, out = step(state, *(jnp.asarray(a[f]) for a in packed[:4]),
                          jnp.eye(4), jnp.asarray(packed[4][f]),
                          jnp.asarray(active[f]))
    x = {"pts": packed[0][PREFIX], "ts": packed[1][PREFIX],
         "mask": packed[2][PREFIX], "has_ts": packed[3][PREFIX],
         "rel": packed[4][PREFIX], "active": active[PREFIX],
         "jax_pose": np.asarray(out.pose)}
    return before, x, (np.asarray(out.pose), np.asarray(out.overflow),
                       np.asarray(state.map.table))


def _ragged(sequences):
    runs = _runs(sequences)
    runs[1] = {k: v[:SHORT] for k, v in runs[1].items()}
    return runs


@pytest.fixture(scope="module")
def four_ranks(sequences, tmp_path_factory):
    """The (2, 2) workers' outputs beside JAX's: the step from JAX's
    state, and ``BatchedOdometryRunner``'s ``run`` and ``run_device`` over
    the drives (the second cut short) against JAX's sharded runner, which
    runs while the workers do."""
    out_dir = str(tmp_path_factory.mktemp("sharded"))
    mesh, step = _jax_step()
    before, x, jax_step = _jax_inputs(sequences, mesh, step)
    np.savez(os.path.join(out_dir, "inputs.npz"), frames=NUM_FRAMES,
             short=SHORT, **{"s_" + k: a for k, a in zip("ptos", before)},
             **{"x_" + k: a for k, a in x.items()})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(_port_cfg(CFG)), f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="4",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, out_dir], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        ragged = _ragged(sequences)
        packed = toffline.pad_batch(ragged, _port_cfg(CFG))
        run = jsharded.make_sharded_sequence_runner(CFG, mesh, donate=False)
        _, jposes, jover = run(j_init(CFG, mesh, 2),
                               *(jnp.asarray(a) for a in packed[:4]),
                               jnp.eye(4), jnp.asarray(packed[4]))
        jax_run = (np.asarray(jposes), np.asarray(jover),
                   _jax_iterations(mesh, step, packed, _active(
                       [dict(r, rel_odometry=packed[4][:, i])
                        for i, r in enumerate(ragged)])))
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r}: OK" in log, log[-3000:]
    outs = []
    for r in range(4):
        outs.append(dict(np.load(os.path.join(out_dir, f"out_{r}.npz"))))
        with open(os.path.join(out_dir, f"loops_{r}.json")) as f:
            outs[-1]["loops"] = json.load(f)
    return outs, jax_step, jax_run, before


def test_four_ranks_step_matches_jax_step(four_ranks):
    outs, (jpose, jover, jtable), _, before = four_ranks
    for o in outs:  # the gathered poses are the whole batch on every rank
        np.testing.assert_allclose(o["step_poses"], jpose, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(o["step_overflow"], jover)
    assert not np.allclose(jpose, before[0])  # the step moved


def test_four_ranks_shard_tables_match_given_the_pose(four_ranks):
    """Given JAX's new pose, each shard's ownership-filtered insert and
    evict leave its table as JAX's shard: every slot's fingerprint and
    exact voxel key and every entry's presence bit-equal.  A stored point
    may sit one 10-bit quantization step off in one axis: XLA fuses the
    multiply-adds of the deskew and the transform on the CPU, and the port
    does not (ROADMAP's hazard list), so a point 1 ulp from a step edge
    lands on the other side."""
    outs, (_, _, jtable), _, before = four_ranks
    k, g = CFG.max_points_per_voxel, CFG.max_probes
    for r, o in enumerate(outs):
        want = sharded_state_from_jax((before[0], jtable, *before[2:]), 2, 2,
                                      r)[1].reshape(-1, g, k + 4)
        got = o["given_pose_table"].reshape(-1, g, k + 4)
        np.testing.assert_array_equal(got[..., k:], want[..., k:])
        words, jwords = got[..., :k], want[..., :k]
        stored = jwords != 0xFFFFFFFF
        np.testing.assert_array_equal(words != 0xFFFFFFFF, stored)
        steps = [np.abs(((words >> s) & 1023).astype(int)
                        - ((jwords >> s) & 1023).astype(int))
                 for s in (0, 10, 20)]
        assert max(a.max() for a in steps) <= 1
        off = words != jwords
        assert off.sum() <= max(2, stored.sum() // 1000), (off.sum(),
                                                            stored.sum())
        # the frame inserted voxels into this shard
        before_r = sharded_state_from_jax(before, 2, 2, r)[1].reshape(
            -1, g, k + 4)
        assert (want[..., k] != 0).sum() > (before_r[..., k] != 0).sum()


def test_four_ranks_runner_matches_jax(four_ranks):
    """``run_device`` (the sharded sequence runner) against JAX's on the
    same padded drives: 1e-5 over each drive's frames; the gathered poses
    are the same on every rank."""
    outs, _, (jposes, _, _), _ = four_ranks
    assert jposes.shape == (NUM_FRAMES, 2, 4, 4)
    for o in outs:
        for i in range(2):
            got = o[f"run_device_{i}"]
            np.testing.assert_allclose(got, jposes[:len(got), i], atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(got, outs[0][f"run_device_{i}"])


def test_four_ranks_buffered_runner_bit_equal_to_eager(four_ranks):
    """On every rank of the (2, 2) mesh, ``run_device``'s buffered step
    (gloo: eager over the step's buffers) gives the eager frame loop's
    poses and final shard state bit for bit."""
    outs = four_ranks[0]
    for o in outs:
        for i, n in enumerate((NUM_FRAMES, SHORT)):
            np.testing.assert_array_equal(o[f"run_device_{i}"],
                                          o["eager_poses"][:n, i])
        for k in "ptos":
            np.testing.assert_array_equal(o["run_state_" + k],
                                          o["eager_state_" + k])


def test_four_ranks_gated_loop_bit_equal_to_always_run(four_ranks):
    """With the GN loop's trips and re-associations skipped as a captured
    frame's IF nodes skip them, every rank's ``run_device`` poses are the
    always-run loop's bit for bit on every frame."""
    outs = four_ranks[0]
    for o in outs:
        for i in range(2):
            np.testing.assert_array_equal(o[f"gated_{i}"],
                                          o[f"run_device_{i}"])


def test_four_ranks_gates_decide_alike_on_a_map_group(four_ranks):
    """Every gate of the loop reads reduced values only, so the two ranks
    of each map group (ranks 2d and 2d + 1) make the same decision at
    every trip and re-association of every frame, and skip some."""
    outs = four_ranks[0]
    for d in range(2):
        a, b = outs[2 * d]["loops"], outs[2 * d + 1]["loops"]
        assert len(a) == len(b) == NUM_FRAMES
        assert [x["decisions"] for x in a] == [x["decisions"] for x in b]
        assert not all(all(x["decisions"]) for x in a)


def test_four_ranks_trips_as_jax_sharded_while_loop(four_ranks):
    """Each frame's gated loop makes as many trips, and associations, as
    the most iterations of the rank's rows (one row a rank here), which
    is what JAX's vmapped sharded ``while_loop`` and its ``lax.cond`` run
    on the same drive: its step's iterations for the row, frame by
    frame."""
    outs, _, (_, _, jits), _ = four_ranks
    assert jits.shape == (NUM_FRAMES, 2)
    for r, o in enumerate(outs):
        trips = [x["trips"] for x in o["loops"]]
        assert trips == [x["associations"] for x in o["loops"]]
        assert trips == [max(x["iterations"]) for x in o["loops"]]
        assert trips == jits[:, r // 2].tolist(), r
    assert jits.min() < CFG.max_num_iterations


def test_four_ranks_run_equals_run_device(four_ranks):
    outs, _, _, _ = four_ranks
    for o in outs:
        assert len(o["run_device_0"]) == NUM_FRAMES
        assert len(o["run_device_1"]) == SHORT
        for i in range(2):
            got = o[f"run_device_{i}"]
            np.testing.assert_allclose(got, o[f"run_{i}"][:len(got)],
                                       atol=1e-5, rtol=0)


def test_four_ranks_every_voxel_on_its_owner(four_ranks):
    """Each stored voxel's exact key hashes (JAX's ``_owner_of``) to the
    shard that holds it; the whole table gathers back (``convert``) with
    every rank's slice in place."""
    outs, _, _, _ = four_ranks
    k, g = CFG.max_points_per_voxel, CFG.max_probes
    counts = []
    for r, o in enumerate(outs):
        slots = o["run_state_t"].reshape(-1, g, k + 4)
        used = slots[..., k] != 0
        keys = slots[used][:, k + 1:].view(np.int32)
        owner = np.asarray(jsharded._owner_of(
            *(jnp.asarray(keys[:, i]) for i in range(3)), 2))
        np.testing.assert_array_equal(owner, np.full(len(keys), r % 2))
        counts.append(len(keys))
    assert min(counts) > 100, counts
    whole = sharded_state_to_jax(
        [[o["run_state_" + k_] for k_ in "ptos"] for o in outs], 2, 2)
    assert whole[1].shape == (2, CFG.map_capacity // g, g * (k + 4))
    for r, o in enumerate(outs):
        part = sharded_state_from_jax(whole, 2, 2, r)
        for a, k_ in zip(part, "ptos"):
            np.testing.assert_array_equal(a, o["run_state_" + k_])

