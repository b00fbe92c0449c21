"""Port vs JAX: the odometry server (blocking, streaming, chunk-scan)."""

import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu.server import LidarOdometryServer as JServer
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch.convert import state_from_numpy
from kinematic_icp_tpu_torch.server import LidarOdometryServer, next_bucket
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_aux.py:87-88
CFG = dict(max_points=4096, max_downsampled=4096, max_source=1024,
           map_capacity=1 << 13, max_range=60.0, deskew=True)
FRAMES = 12
DT = 0.1
#: ROADMAP's short-window rule for poses (tests/test_pallas_gn.py:53-56
#: holds one solve to 1e-7; a frame adds the downsample and the deskew)
POSE_TOL = 1e-5
#: the twist is a pose difference over DT = 0.1 s (the SE(3) log is ~1 near
#: identity): two poses each POSE_TOL off move it by up to 2 POSE_TOL / DT
TWIST_TOL = 2 * POSE_TOL / DT


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(FRAMES)


def _server(**kw):
    return LidarOdometryServer(Config(**CFG), device=CPU, **kw)


def _feed(server, seq, rels=None, blocking=True, frames=None):
    rels = seq["rel_odometry"] if rels is None else rels
    out = []
    for i, (p, t) in enumerate(seq["frames"][:frames]):
        b = blocking(i) if callable(blocking) else blocking
        out.append(server.register_frame(p, t, rels[i], stamp=DT * (i + 1),
                                         blocking=b))
    return out


def _poses(server):
    return np.asarray([p for _, p in server.poses_with_stamps])


def _snapshot(jstate):
    return (np.asarray(jstate.pose), np.asarray(jstate.map.table),
            np.asarray(jstate.threshold.odom_sse),
            np.asarray(jstate.threshold.num_samples))


@pytest.fixture(scope="module")
def jax_run(seq):
    """JAX's blocking server over the drive (one compiled step), with its
    state before every frame, and the port's server over the same frames."""
    js = JServer(JConfig(**CFG), extrinsic=seq["extrinsic"])
    before, results = [], []
    for i, (p, t) in enumerate(seq["frames"]):
        before.append(_snapshot(js.state))  # the step donates its state
        results.append(js.register_frame(p, t, seq["rel_odometry"][i],
                                         stamp=DT * (i + 1)))
    port = _server(extrinsic=seq["extrinsic"])
    port_results = _feed(port, seq)
    return js, before, results, port, port_results


def test_blocking_server_matches_jax_solve_by_solve(seq, jax_run):
    """Each frame from JAX's state before it: the port's pose within
    POSE_TOL of JAX's, its twist within TWIST_TOL, the same gate."""
    js, before, results, _, _ = jax_run
    registered = 0
    for i, (p, t) in enumerate(seq["frames"]):
        s = _server(extrinsic=seq["extrinsic"])
        s.state = state_from_numpy(
            *before[i], bucket_slots=s.config.max_probes, device=CPU)
        s.last_stamp = DT * i if i else None
        res = s.register_frame(p, t, seq["rel_odometry"][i],
                               stamp=DT * (i + 1))
        want = results[i]
        assert res["registered"] == want["registered"]
        registered += res["registered"]
        np.testing.assert_allclose(res["pose"], want["pose"], atol=POSE_TOL,
                                   rtol=0)
        if want["twist"] is None:
            assert res["twist"] is None
        else:
            np.testing.assert_allclose(res["twist"], want["twist"],
                                       atol=TWIST_TOL, rtol=0)
    assert registered == js.frames_registered == FRAMES - 1


def test_blocking_server_matches_jax_over_the_drive(jax_run):
    """Uninterrupted, the two servers' float differences compound; the
    trajectories are judged as ROADMAP's long-horizon rule judges them (ATE
    well under the self-divergence floor), the first frames to POSE_TOL."""
    js, _, results, port, port_results = jax_run
    jposes, tposes = _poses(js), _poses(port)
    assert jposes.shape == tposes.shape == (FRAMES, 4, 4)
    np.testing.assert_allclose(tposes[:4], jposes[:4], atol=POSE_TOL, rtol=0)
    assert ate_rmse(list(jposes), list(tposes), align=False) < 5e-3
    assert port.frames_registered == js.frames_registered
    assert port.frames_skipped == js.frames_skipped == 1
    assert port.overflow_stats == js.overflow_stats
    assert [r["registered"] for r in port_results] == [
        r["registered"] for r in results]
    assert port_results[0]["twist"] is None


def test_set_pose_and_local_map_match_jax(seq, jax_run):
    js, _, _, _, _ = jax_run
    port = _server(extrinsic=seq["extrinsic"])
    port.state = state_from_numpy(*_snapshot(js.state),
                                  bucket_slots=port.config.max_probes,
                                  device=CPU)
    np.testing.assert_array_equal(port.local_map_pointcloud(),
                                  js.local_map_pointcloud())
    assert len(port.local_map_pointcloud()) > 1000
    seed = synthetic.planar_pose(1.0, -2.0, 0.3)
    js.set_pose(seed)
    port.set_pose(seed)
    np.testing.assert_array_equal(port.pose, js.pose)
    assert port.local_map_pointcloud().shape == (0, 3)
    assert js.local_map_pointcloud().shape == (0, 3)
    # after the reset both register the next frames alike
    for i in (1, 2):
        p, t = seq["frames"][i]
        a = js.register_frame(p, t, seq["rel_odometry"][i])
        b = port.register_frame(p, t, seq["rel_odometry"][i])
        np.testing.assert_allclose(b["pose"], a["pose"], atol=POSE_TOL,
                                   rtol=0)


def test_streaming_bit_equal_to_blocking(seq):
    sb = _server(extrinsic=seq["extrinsic"])
    sn = _server(extrinsic=seq["extrinsic"])
    rb = _feed(sb, seq)
    rn = _feed(sn, seq, blocking=False)
    assert [r["registered"] for r in rn] == [r["registered"] for r in rb]
    assert all(r["twist"] is None and r["pose"] is None for r in rn)
    sn.drain()
    np.testing.assert_array_equal(_poses(sb), _poses(sn))
    assert all(isinstance(p, np.ndarray) for _, p in sn.poses_with_stamps)
    assert sn.overflow_stats == sb.overflow_stats
    assert sn.frames_registered == sb.frames_registered
    sn.drain()  # idempotent
    assert sn.overflow_stats == sb.overflow_stats
    np.testing.assert_array_equal(sn.pose, sb.pose)


def test_mixed_blocking_streaming_stationary(seq):
    """Interleaved blocking / streaming / stationary frames give the same
    stamped trajectory as pure blocking mode (tests/test_aux.py:111-136)."""
    rels = list(seq["rel_odometry"])
    rels[3] = np.eye(4)   # stationary mid-stream
    rels[7] = np.eye(4)   # stationary right after a blocking frame
    sb = _server(extrinsic=seq["extrinsic"])
    sn = _server(extrinsic=seq["extrinsic"], stream_chunk=4)
    _feed(sb, seq, rels)
    _feed(sn, seq, rels, blocking=lambda i: i in (5, 6))
    sn.drain()
    np.testing.assert_array_equal(_poses(sb), _poses(sn))
    assert sn.frames_skipped == sb.frames_skipped == 3


@pytest.mark.parametrize("chunk", [5, 4])
def test_scan_stream_mode_matches_steps(seq, chunk):
    """stream_mode='scan' (every row of a chunk, padded partial chunks)
    matches 'steps' to 1e-6 with the same overflow accounting; 11
    registered frames in chunks of 5 leave a partial chunk (1 row + 4
    inactive pads), in chunks of 4 one of 3 rows."""
    servers = {m: _server(extrinsic=seq["extrinsic"], stream_chunk=chunk,
                          stream_mode=m) for m in ("steps", "scan")}
    for s in servers.values():
        _feed(s, seq, blocking=False)
        s.drain()
    a, b = _poses(servers["steps"]), _poses(servers["scan"])
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert servers["scan"].overflow_stats == servers["steps"].overflow_stats
    assert (servers["scan"].frames_registered
            == servers["steps"].frames_registered)


def test_scan_mode_starting_with_stationary_frames(seq):
    rels = list(seq["rel_odometry"])
    rels[1] = np.eye(4)
    steps = _server(extrinsic=seq["extrinsic"], stream_chunk=3)
    scan = _server(extrinsic=seq["extrinsic"], stream_chunk=3,
                   stream_mode="scan")
    for s in (steps, scan):
        _feed(s, seq, rels, blocking=False, frames=7)
        s.drain()
    np.testing.assert_allclose(_poses(scan), _poses(steps), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(_poses(scan)[:2], np.eye(4)[None].repeat(
        2, 0))


def test_drain_accounts_overflow(seq):
    """Tiny capacities drop voxels every frame: blocking warns per frame,
    streaming at drain(), with equal totals (tests/test_aux.py:164-180)."""
    cfg = Config(max_points=4096, max_downsampled=128, max_source=32,
                 map_capacity=1 << 10, max_range=60.0, deskew=False)
    sb = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"], device=CPU)
    sn = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"], device=CPU,
                             overflow_check_interval=0)
    with pytest.warns(RuntimeWarning, match="data loss"):
        _feed(sb, seq, frames=4)
    _feed(sn, seq, blocking=False, frames=4)
    assert sn.overflow_stats["source_dropped"] == 0  # not yet drained
    with pytest.warns(RuntimeWarning, match="data loss"):
        sn.drain()
    assert sn.overflow_stats == sb.overflow_stats
    assert sb.overflow_stats["source_dropped"] > 0


def test_periodic_overflow_check_warns_mid_stream(seq):
    cfg = Config(max_points=4096, max_downsampled=128, max_source=32,
                 map_capacity=1 << 10, max_range=60.0, deskew=False)
    s = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"], device=CPU,
                            stream_chunk=2, overflow_check_interval=2)
    with pytest.warns(RuntimeWarning, match="data loss"):
        _feed(s, seq, blocking=False, frames=3)  # frame 0 is stationary
    assert s._ret_count == 2  # the check read the totals, not a drain
    assert sum(s.overflow_stats.values()) > 0


def test_truncation_counted_and_warned_once(seq):
    s = LidarOdometryServer(Config(**dict(CFG, max_points=2048)),
                            extrinsic=seq["extrinsic"], device=CPU)
    with pytest.warns(RuntimeWarning, match="max_points") as caught:
        _feed(s, seq, frames=3)
    assert len(caught) == 1
    n = sum(len(seq["frames"][i][0]) - 2048 for i in (1, 2)
            if len(seq["frames"][i][0]) > 2048)
    assert s.overflow_stats["points_truncated"] == n > 0


def test_u16_upload_close_to_f32(seq):
    """~1 mm input quantization on a 1 m voxel grid (tests/test_packing.py:
    90-112)."""
    servers = {u: _server(extrinsic=seq["extrinsic"], upload=u)
               for u in ("f32", "u16")}
    for s in servers.values():
        _feed(s, seq)
    ate = ate_rmse(list(_poses(servers["f32"])), list(_poses(servers["u16"])),
                   align=False)
    assert 0 < ate < 0.02


def test_warmup_leaves_state_untouched(seq):
    s = _server(extrinsic=seq["extrinsic"], stream_mode="scan",
                stream_chunk=2)
    pose = s.pose.copy()
    table = s.state.map.table.clone()
    s.warmup(1500, streaming=True)
    assert s.frames_registered == s.frames_skipped == 0
    np.testing.assert_array_equal(s.pose, pose)
    assert torch.equal(s.state.map.table, table)
    r = s.register_frame(seq["frames"][1][0], seq["frames"][1][1],
                         seq["rel_odometry"][1], stamp=0.1)
    assert r["registered"] and np.all(np.isfinite(r["pose"]))


def test_float64_server_returns_float64_poses(seq):
    """A known difference (ROADMAP C): JAX's server returns every pose
    through a float32 buffer; the port's keeps the state's dtype, blocking
    and streaming alike."""
    sb = _server(extrinsic=seq["extrinsic"], dtype=torch.float64)
    sn = _server(extrinsic=seq["extrinsic"], dtype=torch.float64)
    for i, (p, t) in enumerate(seq["frames"][:5]):
        r = sb.register_frame(p, t, seq["rel_odometry"][i], stamp=DT * (i + 1))
        assert sb.state.pose.dtype == torch.float64
        np.testing.assert_array_equal(r["pose"], sb.state.pose.numpy())
    assert not np.array_equal(r["pose"], r["pose"].astype(np.float32))
    _feed(sn, seq, blocking=False, frames=5)
    sn.drain()
    np.testing.assert_array_equal(_poses(sn), _poses(sb))
    np.testing.assert_array_equal(sn.pose, sn.state.pose.numpy())
    # float32 and float64 servers track the same trajectory
    sf = _server(extrinsic=seq["extrinsic"])
    _feed(sf, seq, frames=5)
    np.testing.assert_allclose(_poses(sf), _poses(sb), atol=1e-4, rtol=0)


def test_overflow_totals_are_int32_words(seq):
    """A known difference (ROADMAP C): JAX bit-casts the int32 totals into
    float32 slots of its readback; the port reads them as int32 beside the
    pose's bits."""
    cfg = Config(max_points=4096, max_downsampled=128, max_source=32,
                 map_capacity=1 << 10, max_range=60.0, deskew=False)
    s = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"], device=CPU)
    with pytest.warns(RuntimeWarning):
        _feed(s, seq, frames=3)
    assert s._ovf_acc.dtype == torch.int32
    totals = [s.overflow_stats[k] for k in ("downsample_dropped",
                                            "source_dropped", "insert_failed")]
    assert totals == s._ovf_acc.tolist() and sum(totals) > 0


def test_next_bucket_and_argument_checks():
    assert next_bucket(1, 65536) == 1024
    assert next_bucket(1025, 65536) == 2048
    assert next_bucket(70000, 65536) == 65536
    for kw in (dict(upload="f16"), dict(stream_mode="batch"),
               dict(dtype=torch.float16)):
        with pytest.raises(ValueError):
            _server(**kw)
