"""The GN loop's early exit and the exact modes' fallback as device-side
control flow (``utils.cuda_graph.when`` and ``branch``), on the CPU.

In a captured frame ``when(pred, body)`` is a CUDA-graph IF node: the body
runs only where ``pred`` is set.  Eagerly it always runs the body, whose
updates are masked once the loop would have stopped.  Here
``cuda_graph.when`` is patched with what the IF node does (read ``pred``,
skip the body where it is clear), and every loop solve and a 15-frame
exact drive, at B = 1 and B = 4, is held bit-equal to the always-run
version; each ``run_gn`` call's associations to 1 + (iterations - 1) of
its slowest row, which is what JAX's ``while_loop`` and its ``lax.cond``
make; and the iterations and poses to JAX's ``compute_robot_motion`` on
the same inputs (tolerances as tests/test_torch_registration.py's).  A
stand-in for the capturing graph checks what a capture builds.  The
solves and the capture also run with a ``reduce`` hook over a one-rank
gloo group (the map-sharded path's), which gates its collectives as the
loop without one gates its work.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kinematic_icp_tpu.ops import hashmap as jhm
from kinematic_icp_tpu.ops import registration as jreg
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.ops import hashmap as thm
from kinematic_icp_tpu_torch.ops import registration as treg
from kinematic_icp_tpu_torch.ops.points import P3 as TP3
from kinematic_icp_tpu_torch.utils import cuda_graph, synthetic

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

CAP, K, G = 1 << 13, 20, 4
MAX_IT = 10
MOTION = dict(voxel_size=1.0, max_probes=G, max_num_iterations=MAX_IT,
              convergence_criterion=0.001,
              use_adaptive_odometry_regularization=True,
              fixed_regularization=0.0, threshold_max_range=60.0)
#: the registration branches that run ``run_gn``
MODES = {
    "loop": dict(num_candidate_voxels=10, gn_backend="torch"),
    "full_27": dict(exact_gn_reassociation=True, gn_backend="torch"),
    "pruned": dict(exact_gn_reassociation=True, exact_prune_candidates=14,
                   gn_backend="torch"),
    "certified": dict(exact_gn_reassociation=True, gn_backend="cuda"),
}
#: examples/torch_synthetic_drive.py's small configuration and sensor
SMALL = dict(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0,
             max_probes=4, deskew=True, neighbor_candidates=27,
             exact_gn_reassociation=True)
SMALL_LIDAR = dict(num_beams=256, num_rings=4,
                   ring_angles_deg=(-10.0, -3.0, 0.0, 8.0))
DRIVE_FRAMES = 15


def _if_node(pred, body):
    """What a captured ``when`` does on a replay."""
    if bool(pred):
        body()


@pytest.fixture
def solves(monkeypatch):
    """Wrap ``run_gn``: a list with one [associations, iterations] a call
    (iterations as returned, one a row)."""
    calls = []
    run_gn = treg.run_gn

    def counting(associate, *args, **kw):
        call = [0, None]
        calls.append(call)

        def counted(pose):
            call[0] += 1
            return associate(pose)

        out = run_gn(counted, *args, **kw)
        call[1] = out[1].reshape(-1).tolist()
        return out

    monkeypatch.setattr(treg, "run_gn", counting)
    return calls


@pytest.fixture(scope="module")
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture(params=[None, "gloo"], ids=["local", "reduce"])
def reduced(request, monkeypatch):
    """None, or (the ``reduce`` hook's calls so far, a list) with every
    ``run_gn`` call given a one-rank gloo ``all_reduce(SUM)`` as its
    ``reduce`` hook (an identity on one rank)."""
    if request.param is None:
        return None
    group = request.getfixturevalue("one_rank_group")
    issued = []
    run_gn = treg.run_gn

    def reduce(sums):
        issued.append(sums.shape)
        dist.all_reduce(sums, group=group)
        return sums

    monkeypatch.setattr(treg, "run_gn", lambda *a, **kw: run_gn(
        *a, reduce=reduce, **kw))
    return issued


def _map(map_pts):
    tm = thm.empty(CAP, K, bucket_slots=G)
    tm = thm.insert(tm, TP3.from_array(torch.from_numpy(map_pts)),
                    torch.ones(len(map_pts), dtype=torch.bool), 1.0, G,
                    max_extent=120.0)
    return tm, jhm.MapState(
        table=jnp.asarray(tm.table.numpy().view(np.uint32)), bucket_slots=G)


def _guess(tx, ty=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)


def _walls(rng, n):
    """Points on the walls of a 40 m room (tests/test_registration.py)."""
    wall = rng.integers(0, 4, n)
    s = rng.uniform(-20, 20, n)
    z = rng.uniform(0.0, 3.0, n)
    side = np.where(wall % 2 == 0, -20.0, 20.0)
    x = np.where(wall < 2, s, side)
    y = np.where(wall < 2, side, s)
    return np.stack([x, y, z], 1).astype(np.float32)


#: (guess offset (x, y, yaw), tau) a row: 7 iterations, the certificate
#: fails; 3; 1; 6, the pruned certificate fails
ROWS = [((0.0061, 0.0051, 0.0382), 1.5), ((0.0, 0.0, 0.01), 1.0),
        ((0.01, -0.005, 0.0), 1.0), ((0.0, 0.0, 0.03), 1.0)]


@functools.lru_cache(maxsize=None)
def _scene():
    """The walls of tests/test_torch_registration.py, their noisy points
    as sources, 95 % of them valid.  Returns (port map, JAX map, sources
    (N, 3), mask (N,))."""
    rng = np.random.default_rng(7)
    world = _walls(rng, 2000)
    src = (world[:512] + rng.normal(0, 0.05, (512, 3))).astype(np.float32)
    return (*_map(world), src, rng.uniform(size=512) < 0.95)


def _port(batch, mode):
    """The port's solve of ROWS[0] (``batch`` 0) or of the first ``batch``
    rows as one batch."""
    tm, _, src, mask = _scene()
    rows = ROWS[:max(batch, 1)]
    guesses = torch.from_numpy(np.stack([_guess(*g) for g, _ in rows]))
    tau = torch.tensor([t for _, t in rows])
    src, mask = torch.from_numpy(src), torch.from_numpy(mask)
    if batch:
        tm = thm.MapState(tm.table.expand(batch, *tm.table.shape).clone(),
                          tm.bucket_slots)
        src, mask = src.expand(batch, -1, -1), mask.expand(batch, -1)
        eye = torch.eye(4).expand(batch, 4, 4)
    else:
        guesses, tau, eye = guesses[0], tau[0], torch.eye(4)
    return treg.compute_robot_motion(
        tm, TP3.from_array(src), mask, eye, guesses, tau,
        **{**MOTION, **MODES[mode]})


@functools.lru_cache(maxsize=None)
def _jax_solver(static):
    kw = dict(static)
    return jax.jit(lambda m, src, mask, guess, tau: jreg.compute_robot_motion(
        m, src, mask, jnp.eye(4, dtype=jnp.float32), guess, tau, **kw))


def _bits(t):
    return t.reshape(-1).view(torch.uint8) if t.is_floating_point() else t


def _assert_same(a, b):
    (pa, da), (pb, db) = a, b
    assert torch.equal(_bits(pa), _bits(pb))
    for x, y in zip(da, db):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("batch", [0, 4], ids=["single", "b4"])
@pytest.mark.parametrize("mode", list(MODES))
def test_gated_solve_bit_equal_to_always_run(monkeypatch, solves, reduced,
                                             mode, batch):
    """Each trip and re-association skipped where no row needs it, as the
    IF nodes skip them: every output bit-equal to the always-run loop,
    whose every call makes MAX_IT associations; the gated call makes 1 +
    (iterations - 1) of its slowest row.  With a ``reduce`` hook the same,
    and the hook runs once a trip made, beside β's sums and the final
    count: MAX_IT + 2 a call always run, 1 + iterations of the slowest
    row gated."""
    always = _port(batch, mode)
    assert all(n == MAX_IT for n, _ in solves)
    if reduced is not None:
        assert len(reduced) == (MAX_IT + 2) * len(solves)
        reduced.clear()
    solves.clear()
    monkeypatch.setattr(cuda_graph, "when", _if_node)
    gated = _port(batch, mode)
    _assert_same(gated, always)
    assert solves and all(n == max(its) for n, its in solves)
    assert min(n for n, _ in solves) < MAX_IT  # something was skipped
    if reduced is not None:
        assert len(reduced) == sum(max(its) + 2 for _, its in solves)
    if mode in ("pruned", "certified"):
        # the first row's certificate fails: the full-27 loop ran
        assert bool(gated[1].exact_fallback.reshape(-1)[0])
        assert len(solves) == 1 + (mode == "pruned")


@pytest.mark.parametrize("batch", [0, 4], ids=["single", "b4"])
@pytest.mark.parametrize("mode", list(MODES))
def test_gated_solve_matches_jax_while_loop(monkeypatch, solves, mode,
                                            batch):
    """The same inputs through JAX's ``compute_robot_motion``, a row at a
    time: iterations and correspondences equal and poses within 1e-6 in
    every row, and each gated ``run_gn`` call's associations 1 + the most
    re-associations JAX made in a row (its ``lax.cond`` re-associates on
    every trip but the last).  JAX's certified branch needs the Pallas
    kernel, so a certified row is held to JAX's full-27 loop where its
    certificate failed (its fallback), as the port's fallback is."""
    monkeypatch.setattr(cuda_graph, "when", _if_node)
    pose, debug = _port(batch, mode)
    _, jm, src, mask = _scene()
    solve = _jax_solver(tuple(sorted(
        {**MOTION, **MODES[mode], "gn_backend": "xla"}.items())))
    pose = pose.reshape(-1, 4, 4).numpy()
    its = debug.iterations.reshape(-1).tolist()
    ncorr = debug.num_correspondences.reshape(-1).tolist()
    fell = (debug.exact_fallback.reshape(-1).tolist()
            if debug.exact_fallback is not None else [False] * len(its))
    jits = []
    for r, (guess, tau) in enumerate(ROWS[:len(its)]):
        jpose, jdbg = solve(jm, JP3.from_array(jnp.asarray(src)),
                            jnp.asarray(mask), jnp.asarray(_guess(*guess)),
                            jnp.float32(tau))
        jits.append(int(jdbg.iterations))
        if mode == "certified" and not fell[r]:
            continue
        np.testing.assert_allclose(pose[r], np.asarray(jpose), atol=1e-6,
                                   rtol=0)
        assert its[r] == jits[r]
        assert ncorr[r] == int(jdbg.num_correspondences)
        if mode == "pruned":
            assert fell[r] == bool(jdbg.exact_fallback)
    # the last call is the full-27 fallback where one ran, else the only
    # one: its rows iterate as JAX's loop does, and it associates 1 + the
    # most re-associations of a row
    assert solves[-1] == [max(jits), jits]


@functools.lru_cache(maxsize=None)
def _drives():
    """Four small drives (tests/test_parallel.py's seeds)."""
    return [synthetic.make_sequence(
        DRIVE_FRAMES, world_seed=s, traj_seed=s + 10, noise_seed=s + 20,
        lidar=synthetic.LidarModel(**SMALL_LIDAR)) for s in range(4)]


#: the drive run alone: the one whose certified certificate fails on a
#: frame (the pruned one fails on four)
SINGLE = 2


def _drive(cfg, batch):
    """(poses, fallback frames) of drive SINGLE through ``run_offline``
    (``batch`` 0), or of the four drives through the batched runner."""
    if not batch:
        seq = _drives()[SINGLE]
        poses, _, stats = toffline.run_offline(
            seq["frames"], seq["rel_odometry"], cfg, device="cpu",
            return_stats=True)
        return torch.from_numpy(np.asarray(poses)), torch.tensor(
            stats["exact_fallback_frames"])
    arrays = toffline.pad_batch(_drives(), cfg)
    _, poses, _, fallbacks, _ = toffline.make_batched_sequence_runner(
        cfg, device="cpu")(
        toffline.init_batched_state(cfg, batch, device="cpu"),
        *(torch.from_numpy(a) for a in arrays[:4]), torch.eye(4),
        torch.from_numpy(arrays[4]))
    return poses, fallbacks


@pytest.mark.parametrize("batch", [0, 4], ids=["single", "b4"])
@pytest.mark.parametrize("mode", ["certified", "pruned"])
def test_gated_exact_drive_bit_equal_to_always_run(monkeypatch, solves,
                                                   mode, batch):
    """15 frames of the small exact drive (examples/torch_synthetic_drive
    .py's configuration), one drive and a batch of 4: with trips and
    re-associations skipped as the IF nodes skip them, every pose and the
    fallback counts bit-equal to the always-run loop's, with fewer
    associations (each call 1 + (iterations - 1) of its slowest row)."""
    cfg = Config(**SMALL).replace(**{k: v for k, v in MODES[mode].items()
                                     if k != "exact_gn_reassociation"})
    always = _drive(cfg, batch)
    made = sum(n for n, _ in solves)
    assert made == MAX_IT * len(solves)
    solves.clear()
    monkeypatch.setattr(cuda_graph, "when", _if_node)
    gated = _drive(cfg, batch)
    for a, b in zip(gated, always):
        assert torch.equal(_bits(a), _bits(b))
    assert int(gated[1].sum()) > 0  # some frame fell back
    assert all(n == max(its) for n, its in solves)
    assert sum(n for n, _ in solves) < made


class _Capture:
    """Stands in for a static call's capture: records each IF node's
    nesting depth (reading no predicate) and, as a capture records a body,
    lets every body run (on the current stream: ``begin_if`` returns
    none)."""

    def __init__(self):
        self.nodes, self.depth = [], 0

    def begin_if(self, pred):
        assert pred.dtype == torch.bool and pred.dim() == 0
        self.nodes.append(self.depth)
        self.depth += 1

    def end_if(self):
        self.depth -= 1


def test_branch_writes_only_into_its_tensors(monkeypatch):
    """Eagerly ``branch`` returns the fallback's values where some row is
    set and its tensors, untouched, where none is.  Under capture it
    returns its own tensors, with the fallback's values copied into them
    inside one IF node, whatever the flag: the frame after the node reads
    only tensors that exist before it."""
    tensors = (torch.arange(4.0), torch.zeros(4, dtype=torch.int32))
    made = []

    def fallback():
        made.extend((tensors[0] * 10.0, tensors[1] + 7))
        return tuple(made[-2:])

    assert cuda_graph.branch(torch.zeros(4, dtype=torch.bool), fallback,
                             tensors) is tensors and not made
    out = cuda_graph.branch(torch.tensor([False, True]), fallback, tensors)
    assert out[0] is made[0] and out[1] is made[1]
    assert torch.equal(tensors[0], torch.arange(4.0))

    capture = _Capture()
    monkeypatch.setattr(cuda_graph, "_active", capture)
    out = cuda_graph.branch(torch.tensor([False, True]), fallback, tensors)
    assert out is tensors and capture.nodes == [0] and capture.depth == 0
    assert torch.equal(tensors[0], torch.arange(4.0) * 10.0)
    assert torch.equal(tensors[1], torch.full((4,), 7, dtype=torch.int32))
    assert all(m is not t for m in made for t in tensors)


def test_when_nests_and_refuses_what_a_replay_cannot_redo(monkeypatch):
    """Under capture ``when`` is an IF node around its body, nested where
    bodies nest; it refuses a predicate that is not one bool and a
    registered counter moved inside a body (a replay cannot tell whether
    the body ran), and a node it cannot build raises without running the
    body another way.  Eagerly and in a warm-up every body runs."""
    from kinematic_icp_tpu_torch.ops import gn

    ran = []
    yes = torch.tensor(True)
    for active in (None, cuda_graph._WARMUP):
        monkeypatch.setattr(cuda_graph, "_active", active)
        cuda_graph.when(torch.tensor(False), lambda: ran.append(active))
    assert ran == [None, cuda_graph._WARMUP]

    capture = _Capture()
    monkeypatch.setattr(cuda_graph, "_active", capture)
    cuda_graph.when(yes, lambda: cuda_graph.when(
        yes, lambda: cuda_graph.when(yes, lambda: ran.append(3))))
    assert capture.nodes == [0, 1, 2] and capture.depth == 0
    assert ran[-1] == 3
    with pytest.raises(ValueError, match="bool"):
        cuda_graph.when(torch.tensor([True, False]), lambda: None)
    with pytest.raises(ValueError, match="bool"):
        cuda_graph.when(torch.tensor(1), lambda: None)

    def launch():
        gn.LAUNCHES += 1

    before = gn.LAUNCHES
    try:
        with pytest.raises(RuntimeError, match="counter"):
            cuda_graph.when(yes, launch)
    finally:
        gn.LAUNCHES = before
    assert capture.depth == 0

    def unbuilt(pred):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(capture, "begin_if", unbuilt)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_graph.when(yes, lambda: ran.append("fallback"))
    assert ran[-1] == 3


def _loop(depth):
    """A captured ``run_gn``'s IF nodes at ``depth``, by nesting depth in
    capture order: the first trip runs unconditionally and holds its
    re-association's node; each later trip is a node with its
    re-association's nested inside, but for the last trip's, which does
    not re-associate."""
    return [depth] + [depth, depth + 1] * (MAX_IT - 2) + [depth]


@pytest.mark.parametrize("mode,nodes", [
    ("loop", _loop(0)), ("full_27", _loop(0)),
    ("pruned", _loop(0) + [0] + _loop(1)), ("certified", [0] + _loop(1))])
def test_capture_builds_the_while_loop_and_the_fallback_as_if_nodes(
        monkeypatch, reduced, mode, nodes):
    """The IF nodes a captured batched solve holds: the loop's trips and
    re-associations, and the exact modes' fallback as one node around the
    full-27 loop's; with a ``reduce`` hook the same nodes, the hook's
    collectives of the later trips inside them."""
    capture = _Capture()
    monkeypatch.setattr(cuda_graph, "_active", capture)
    _port(4, mode)
    assert capture.nodes == nodes and capture.depth == 0
    if reduced is not None:
        # every trip's sums (MAX_IT a loop) and β's and the count's
        loops = 1 + (mode == "pruned")
        assert len(reduced) == (MAX_IT + 2) * loops
