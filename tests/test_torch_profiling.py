"""The port's spans and counters (``utils/profiling.py``): off by default,
host events under ``torch.profiler``, samples on the profiler's clock in a
bounded buffer, and the GN counts the server and the batched runner read
back, held to the per-frame outputs they sum."""

import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.models import pipeline
from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
from kinematic_icp_tpu_torch.server import LidarOdometryServer
from kinematic_icp_tpu_torch.utils import cuda_graph, profiling, synthetic

torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_torch_batched_exact.py's drives and configuration: the
#: certified solve falls back on some frames of some drives, not all
CFG = Config(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0,
             max_probes=4, deskew=True)
EXACT = dict(neighbor_candidates=27, exact_gn_reassociation=True,
             gn_backend="cuda")
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
NUM_FRAMES = 8
DT = 0.1
MODES = {"default": {}, "certified": EXACT}
#: the ``gn`` sample's keys, in ``pipeline.COUNTS``' order
GN_KEYS = ("frames", "passes", "sources", "fallbacks", "fallback_trips")


@pytest.fixture(scope="module")
def drives():
    return [synthetic.make_sequence(NUM_FRAMES, world_seed=s,
                                    traj_seed=s + 10, noise_seed=s + 20,
                                    lidar=synthetic.LidarModel(**LIDAR))
            for s in range(3)]


@pytest.fixture
def empty_buffer():
    profiling._buffer.clear()
    yield profiling._buffer
    profiling._buffer.clear()


def _feed(server, seq, blocking=True):
    for i, (p, t) in enumerate(seq["frames"]):
        server.register_frame(p, t, seq["rel_odometry"][i],
                              stamp=DT * (i + 1), blocking=blocking)


def _host_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.device_type())
            for e in prof.profiler.kineto_results.events()]


# --- off: no recording, no cost -------------------------------------------

def test_span_with_nothing_recording_calls_no_record_function(monkeypatch,
                                                              empty_buffer):
    """With no profiler and no ``recording()`` a span is one shared object
    that enters no record function and allocates nothing."""
    def refuse(*args):
        raise AssertionError("record function entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not profiling._recording
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("kicp.a") is profiling.span("kicp.b")
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with profiling.span("kicp.pack"):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 512
    assert len(empty_buffer) == 0


def test_count_with_nothing_recording_appends_nothing(empty_buffer):
    profiling.count("gn", frames=1, passes=3, sources=100, fallbacks=0)
    assert len(empty_buffer) == 0
    with profiling.recording():
        profiling.count("gn", frames=1, passes=3, sources=100, fallbacks=0)
    profiling.count("gn", frames=1, passes=3, sources=100, fallbacks=0)
    assert [v for _, v in profiling.samples("gn")] == [
        {"frames": 1, "passes": 3, "sources": 100, "fallbacks": 0}]


# --- under the profiler: host events, nested ------------------------------

def _run_live():
    seq = synthetic.make_sequence(3, lidar=synthetic.LidarModel(**LIDAR))
    _feed(LidarOdometryServer(CFG, extrinsic=seq["extrinsic"], device=CPU),
          seq)
    return "kicp.register_frame", {"kicp.pack", "kicp.upload",
                                   "kicp.readback"}


def _run_offline():
    seq = synthetic.make_sequence(3, lidar=synthetic.LidarModel(**LIDAR))
    BatchedOdometryRunner(CFG, 2, extrinsic=seq["extrinsic"],
                          device=CPU).run_device([seq])
    return "kicp.run_device", {"kicp.pad_batch", "kicp.upload",
                               "kicp.frames", "kicp.readback"}


@pytest.mark.parametrize("run", [_run_live, _run_offline],
                         ids=["register_frame", "run_device"])
def test_spans_are_nested_host_events_under_the_profiler(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer, children = run()
    events = [e for e in _host_events(prof) if e[0].startswith("kicp.")]
    assert events
    assert all(d != DeviceType.CUDA for *_, d in events)
    parents = [e for e in events if e[0] == outer]
    assert parents
    seen = set()
    for name, s, e, _ in events:
        if name in children:
            assert any(ps <= s and e <= pe for _, ps, pe, _ in parents), name
            seen.add(name)
    assert seen == children


def test_launch_spans_a_replay_and_its_counters(empty_buffer):
    """``kicp.launch`` covers a captured call's replay and the counters'
    effects, and only the replay path (the eager call has none)."""
    order = []

    class Replayed:
        def replay(self):
            order.append("replay")

        def apply(self):
            order.append("apply")

    call = cuda_graph.StaticCall(lambda: "eager", (), capture=True)
    call._graph = call._effects = Replayed()
    call.outputs = "replayed"
    with profiling.recording():
        assert call() == "replayed"
        eager = cuda_graph.StaticCall(lambda: "eager", (), capture=False)
        assert eager() == "eager"
    assert order == ["replay", "apply"]
    (t, v), = profiling.samples("kicp.launch")
    assert t <= v["end_ns"]


def test_a_count_lies_inside_the_profiler_event_around_it(empty_buffer):
    """The buffer's clock is the profiler's: a sample taken inside a
    ``record_function`` falls within that event's [start_ns, end_ns]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"outer{i}"):
                torch.ones(8).sum()
                profiling.count("gn", frames=i)
                torch.ones(8).sum()
    spans = {n: (s, e) for n, s, e, _ in _host_events(prof)
             if n.startswith("outer")}
    got = profiling.samples("gn")
    assert len(got) == 3
    for t, v in got:
        s, e = spans[f"outer{v['frames']}"]
        assert s <= t <= e
        assert profiling.samples("gn", s, e) == [(t, v)]


def test_the_buffer_keeps_its_bound(empty_buffer):
    n = profiling.BUFFER_SAMPLES
    with profiling.recording():
        for i in range(n + 10):
            profiling.count("gn", frames=i)
    assert len(empty_buffer) == n
    got = profiling.samples("gn")
    assert got[0][1]["frames"] == 10 and got[-1][1]["frames"] == n + 9


# --- the counts ------------------------------------------------------------

def _spy_frames(monkeypatch):
    """Each ``pipeline.register_frame`` call's outputs, as the server's
    eager steps on the CPU run it."""
    seen = []
    register = pipeline.register_frame

    def spy(*args, **kw):
        state, out = register(*args, **kw)
        seen.append(out)
        return state, out

    monkeypatch.setattr(pipeline, "register_frame", spy)
    return seen


@pytest.mark.parametrize("mode", list(MODES))
def test_frame_stats_sum_the_frames_register_frame_outputs(
        drives, mode, monkeypatch, empty_buffer):
    """A blocking server's ``frame_stats`` over three drives are the sums
    of its frames' GN passes (``debug.iterations``; on a frame that fell
    back the first solve's, ``debug.solve_iterations``), live sources,
    fallback flags and the fallback loop's trips (``debug.iterations`` on
    a frame that fell back), and the ``gn`` samples recorded at its
    read-backs sum to the same."""
    cfg = CFG.replace(**MODES[mode])
    seen = _spy_frames(monkeypatch)
    totals = dict.fromkeys(pipeline.COUNTS, 0)
    with profiling.recording():
        for seq in drives:
            server = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"],
                                         device=CPU)
            _feed(server, seq)
            for k, v in server.frame_stats.items():
                totals[k] += v
    want = dict.fromkeys(pipeline.COUNTS, 0)
    for out in seen:
        d = out.debug
        fell = d.exact_fallback is not None and bool(d.exact_fallback)
        want["frames"] += 1
        want["gn_passes"] += int(d.solve_iterations if fell
                                 else d.iterations)
        want["gn_sources"] += int(out.source_mask.sum())
        want["exact_fallback_frames"] += fell
        want["exact_fallback_trips"] += int(d.iterations) if fell else 0
        if d.solve_iterations is not None and not fell:
            assert torch.equal(d.solve_iterations, d.iterations)
    assert totals == want
    assert want["frames"] == 3 * (NUM_FRAMES - 1) and want["gn_passes"] > 0
    if mode == "certified":
        assert 0 < want["exact_fallback_frames"] < want["frames"]
        assert want["exact_fallback_trips"] >= want["exact_fallback_frames"]
    samples = [v for _, v in profiling.samples("gn")]
    assert len(samples) == want["frames"]
    assert [sum(v[k] for v in samples) for k in GN_KEYS] == list(
        want.values())


@pytest.mark.parametrize("batch", [0, 4])
def test_trips_column_is_the_fallback_loop_iterations(drives, batch):
    """Each frame's ``exact_fallback_trips`` column (certified exact, one
    drive at a time and the three drives at B = 4 with a padding row) is
    ``debug.iterations`` where the frame fell back and 0 elsewhere, and
    the stationary padding row counts nothing (each frame as the sequence
    runners call ``register_frame``: the stationary gate and deskew twists
    of ``offline._per_frame_constants``)."""
    cfg = CFG.replace(**EXACT)
    col = pipeline.COUNTS.index("exact_fallback_trips")
    ext = torch.from_numpy(np.asarray(drives[0]["extrinsic"], np.float32))
    runs = []
    if batch:
        runs.append((toffline.init_batched_state(cfg, batch, device=CPU),
                     toffline.pad_batch(drives, cfg, batch)))
    else:
        runs += [(pipeline.init_state(cfg, device=CPU),
                  toffline.pad_sequence(d["frames"], d["rel_odometry"], cfg))
                 for d in drives]
    fell_any = held_any = False
    for state, arrays in runs:
        pts, ts, mask, has_ts, rels = (torch.from_numpy(a) for a in arrays)
        actives, twists = toffline._per_frame_constants(rels, ext, cfg)
        for f in range(len(rels)):
            state, out = pipeline.register_frame(
                state, pts[f], ts[f], mask[f], has_ts[f], ext, rels[f], cfg,
                active=actives[f], rel_twist_in_lidar=twists[f])
            d = out.debug
            want = torch.where(d.exact_fallback & actives[f], d.iterations,
                               0)
            assert torch.equal(out.counts[..., col], want.to(torch.int32))
            fell_any |= bool(d.exact_fallback.any())
            held_any |= bool((~d.exact_fallback & (d.iterations > 0)).any())
    assert fell_any and held_any


def test_ret_row_and_stats_carry_the_trips(drives):
    """The server's read-back row holds the frame's five counts between
    the pose and the overflow totals, and both operators' totals key the
    trips."""
    from kinematic_icp_tpu_torch import server as tserver

    assert len(pipeline.COUNTS) + len(pipeline.OVERFLOW) == 8
    cfg = CFG.replace(**EXACT)
    state = pipeline.init_state(cfg, device=CPU)
    counts = torch.arange(5, dtype=torch.int32)
    row = tserver._ret(state, counts, torch.zeros(3, dtype=torch.int32))
    assert row.shape == (16 + 8,) and torch.equal(row[16:21], counts)
    words, got, overflow = pipeline.unpack_tallies(row)
    assert torch.equal(words.view(torch.float32).reshape(4, 4), state.pose)
    assert torch.equal(got, counts) and not overflow.any()
    s = LidarOdometryServer(cfg, extrinsic=drives[0]["extrinsic"], device=CPU)
    r = BatchedOdometryRunner(cfg, 2, device=CPU)
    for stats in (s.frame_stats, r.stats):
        assert list(stats) == list(pipeline.COUNTS)
        assert "exact_fallback_trips" in stats


@pytest.mark.parametrize("stream_mode", ["steps", "scan"])
def test_streaming_keeps_its_poses_and_counts_with_the_wider_row(
        drives, stream_mode):
    """Streamed frames (chunks of 3, read back at ``drain()``) against
    blocking ones: "steps" poses bit-equal, "scan" within 1e-6 (its
    documented rounding), the same frame counts (the scan's padding rows
    count nothing) and the same overflow totals."""
    seq = drives[1]
    servers = {}
    for blocking in (True, False):
        s = LidarOdometryServer(CFG, extrinsic=seq["extrinsic"], device=CPU,
                                stream_chunk=3, stream_mode=stream_mode)
        _feed(s, seq, blocking)
        s.drain()
        servers[blocking] = s
    poses = {b: np.asarray([p for _, p in s.poses_with_stamps])
             for b, s in servers.items()}
    if stream_mode == "steps":
        np.testing.assert_array_equal(poses[False], poses[True])
        assert servers[False].frame_stats == servers[True].frame_stats
    else:
        np.testing.assert_allclose(poses[False], poses[True], atol=1e-6,
                                   rtol=0)
        assert (servers[False].frame_stats["frames"]
                == servers[True].frame_stats["frames"] == NUM_FRAMES - 1)
    assert servers[False].overflow_stats == servers[True].overflow_stats


@pytest.mark.parametrize("stream_mode", ["steps", "scan"])
def test_serve_count_a_drain(drives, stream_mode, empty_buffer):
    """Streamed frames in chunks of 3, the overflow read every 3: one
    ``serve`` count at the drain that finds frames in flight, none at one
    that finds none nor for blocking frames.  Its waits: an upload a
    chunk, the overflow reads after the first two chunks, the pose of the
    stationary first frame (read before any frame is logged) and the
    drain's read-back."""
    seq = drives[1]
    with profiling.recording():
        s = LidarOdometryServer(CFG, extrinsic=seq["extrinsic"], device=CPU,
                                stream_chunk=3, stream_mode=stream_mode,
                                overflow_check_interval=3)
        _feed(s, seq, blocking=False)
        s.drain()
        s.drain()
        _feed(LidarOdometryServer(CFG, extrinsic=seq["extrinsic"],
                                  device=CPU), seq)
    assert [v for _, v in profiling.samples("serve")] == [
        {"frames": NUM_FRAMES - 1, "flushes": 3, "waits": 3 + 2 + 1 + 1}]
    assert s.frame_stats["frames"] == NUM_FRAMES - 1


def test_run_device_keeps_the_counts_it_read_back(drives, empty_buffer):
    """``BatchedOdometryRunner.run_device`` (certified, B = 4, three
    drives: a padding row) in two chunks: each row's ``stats`` equal its
    drive's own ``run_offline`` fallbacks and the unbatched runner's
    counts, and a ``gn`` sample per chunk sums the batch."""
    cfg = CFG.replace(**EXACT)
    runner = BatchedOdometryRunner(cfg, 4, extrinsic=drives[0]["extrinsic"],
                                   device=CPU)
    with profiling.recording():
        for a, b in ((0, 5), (5, NUM_FRAMES)):
            runner.run_device([{"frames": d["frames"][a:b],
                                "rel_odometry": d["rel_odometry"][a:b]}
                               for d in drives])
    assert len(profiling.samples("gn")) == 2
    for i, seq in enumerate(drives):
        _, _, stats = toffline.run_offline(
            seq["frames"], seq["rel_odometry"], cfg,
            extrinsic=seq["extrinsic"], device=CPU, return_stats=True)
        assert runner.stats["exact_fallback_frames"][i] == \
            stats["exact_fallback_frames"]
        arrays = [torch.from_numpy(x) for x in toffline.pad_sequence(
            seq["frames"], seq["rel_odometry"], cfg)]
        counts = toffline.make_sequence_runner(cfg, CPU)(
            pipeline.init_state(cfg, device=CPU), *arrays[:4],
            torch.from_numpy(np.asarray(seq["extrinsic"], np.float32)),
            arrays[4])[4]
        assert [int(runner.stats[k][i]) for k in pipeline.COUNTS] == \
            counts.tolist()
    assert all(runner.stats[k][3] == 0 for k in pipeline.COUNTS)
    assert runner.stats["exact_fallback_frames"].sum() > 0
    total = [sum(v[k] for _, v in profiling.samples("gn")) for k in GN_KEYS]
    assert total == [int(runner.stats[k].sum()) for k in pipeline.COUNTS]
    assert (runner.stats["exact_fallback_trips"]
            >= runner.stats["exact_fallback_frames"]).all()
