"""Port vs JAX: one register_frame, a short drive, and state carried over."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu import offline as joffline
from kinematic_icp_tpu.models import pipeline as jpipe
from kinematic_icp_tpu.ops import hashmap as jhm
from kinematic_icp_tpu.ops import pallas_gn
from kinematic_icp_tpu.ops import registration as jreg
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.convert import state_from_numpy, state_to_numpy
from kinematic_icp_tpu_torch.models import pipeline as tpipe
from kinematic_icp_tpu_torch.ops import gn
from kinematic_icp_tpu_torch.ops import registration as treg
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

CPU = "cpu"

#: __graft_entry__.py:20-22
GRAFT_CFG = JConfig(max_points=4096, max_downsampled=4096, max_source=2048,
                    map_capacity=1 << 13, voxel_size=1.0, max_range=60.0,
                    deskew=True)
#: __graft_entry__.py:66-70
DRIVE_CFG = JConfig(max_points=1024, max_downsampled=1024, max_source=512,
                    map_capacity=4096, voxel_size=1.0, max_range=15.0,
                    max_probes=4, deskew=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
FRAMES = 15


def _port_cfg(jcfg):
    return Config.from_dict(dataclasses.asdict(jcfg))


def _table(m):
    return np.asarray(m.table).view(np.uint32)


def test_config_from_dict_maps_backends():
    cfg = _port_cfg(GRAFT_CFG.replace(gn_backend="pallas"))
    assert cfg.gn_backend == "cuda" and cfg.max_source == 2048
    assert _port_cfg(GRAFT_CFG.replace(gn_backend="xla")).gn_backend == "torch"
    assert cfg.map_resolution() == GRAFT_CFG.map_resolution()


def test_register_frame_matches_jax():
    """__graft_entry__.py:25-33 inputs: two frames through both packages."""
    rng = np.random.default_rng(0)
    n = GRAFT_CFG.max_points
    step = jpipe.make_step(GRAFT_CFG, donate=False)
    cfg = _port_cfg(GRAFT_CFG)
    jstate = jpipe.init_state(GRAFT_CFG)
    tstate = tpipe.init_state(cfg, device=CPU)
    for frame in range(2):
        pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        ts = rng.uniform(0, 1, n).astype(np.float32)
        rel = np.eye(4, dtype=np.float32)
        rel[0, 3] = 0.3
        jstate, jout = step(jstate, jnp.asarray(pts), jnp.asarray(ts),
                            jnp.ones(n, bool), jnp.bool_(True), jnp.eye(4),
                            jnp.asarray(rel))
        tstate, tout = tpipe.register_frame(
            tstate, torch.from_numpy(pts), torch.from_numpy(ts),
            torch.ones(n, dtype=torch.bool), torch.tensor(True),
            torch.eye(4), torch.from_numpy(rel), cfg)
        np.testing.assert_allclose(tstate.pose.numpy(),
                                   np.asarray(jstate.pose), atol=1e-5)
        np.testing.assert_array_equal(tout.overflow.numpy(),
                                      np.asarray(jout.overflow))
        if frame == 0:
            # the map after the first frame is bit-equal
            np.testing.assert_array_equal(state_to_numpy(tstate)[1],
                                          _table(jstate.map))
    assert int(tout.debug.num_correspondences) > 0


@pytest.fixture(scope="module")
def drive():
    seq = synthetic.make_sequence(FRAMES + 1,
                                  lidar=synthetic.LidarModel(**LIDAR))
    frames, rels = seq["frames"][:FRAMES], seq["rel_odometry"][:FRAMES]
    arrays = joffline.pad_sequence(frames, rels, DRIVE_CFG)
    runner = joffline.make_sequence_runner(DRIVE_CFG)
    jstate, jposes, jover, _ = runner(
        jpipe.init_state(DRIVE_CFG), *(jnp.asarray(a) for a in arrays[:4]),
        jnp.eye(4), jnp.asarray(arrays[4]))
    return seq, jstate, np.asarray(jposes), np.asarray(jover)


def _port_run(cfg, frames, rels, state):
    arrays = toffline.pad_sequence(frames, rels, cfg)
    runner = toffline.make_sequence_runner(cfg, device=CPU)
    # (state, poses, overflow, fallbacks), without the counts
    return runner(state, *(torch.from_numpy(a) for a in arrays[:4]),
                  torch.eye(4), torch.from_numpy(arrays[4]))[:4]


@pytest.mark.parametrize("gn_backend", ["torch", "cuda"])
def test_drive_matches_jax(drive, gn_backend):
    """The JAX drive (its "xla" loop on the CPU) against the port's loop
    lowering and against its kernel branch, which on CPU tensors runs the
    kernel's plain version."""
    seq, _, jposes, jover = drive
    cfg = _port_cfg(DRIVE_CFG).replace(gn_backend=gn_backend)
    _, tposes, tover, _ = _port_run(cfg, seq["frames"][:FRAMES],
                                    seq["rel_odometry"][:FRAMES],
                                    tpipe.init_state(cfg, device=CPU))
    tposes = tposes.numpy()
    np.testing.assert_array_equal(tover.numpy(), jover)
    np.testing.assert_allclose(tposes[:3], jposes[:3], atol=1e-5)
    assert ate_rmse(list(jposes), list(tposes), align=False) < 5e-3
    # the drive moved: the map was updated and registration did work
    assert np.linalg.norm(tposes[-1][:3, 3]) > 2.0


def test_run_offline_entry_point(drive):
    seq, _, jposes, _ = drive
    poses, state = toffline.run_offline(
        seq["frames"][:FRAMES], seq["rel_odometry"][:FRAMES],
        _port_cfg(DRIVE_CFG), extrinsic=seq["extrinsic"], device=CPU)
    assert poses.dtype == np.float64 and poses.shape == (FRAMES, 4, 4)
    assert ate_rmse(list(jposes), list(poses), align=False) < 5e-3
    assert state.map.table.device.type == CPU


def _sse_tolerance(poses, preds, max_range, pose_diff):
    """How far the accumulated squared point-space errors of two runs may
    drift: each frame's error 2 R sin(theta/2) + |t| of pred^-1 @ pose is
    ill-conditioned near a zero rotation (ROADMAP C), so each gets
    ``gn.error_tolerance`` with the pose difference plus a few ulps of the
    rotation trace, and d(e^2) <= (2 e + de) de."""
    total = 0.0
    for pose, pred in zip(poses, preds):
        e = np.linalg.inv(pred) @ pose
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        err = np.linalg.norm(e[:3, 3]) + 2 * max_range * np.sqrt((1 - c) / 2)
        de = gn.error_tolerance(pose, pred, max_range, pose_diff + 5e-7)
        total += (2.0 * err + de) * de
    return total


def test_register_frame_exact_matches_jax():
    """Two frames of the full-27 re-gather loop through both packages."""
    jcfg = GRAFT_CFG.replace(neighbor_candidates=27,
                             exact_gn_reassociation=True)
    rng = np.random.default_rng(1)
    n = jcfg.max_points
    step = jpipe.make_step(jcfg, donate=False)
    cfg = _port_cfg(jcfg)
    jstate = jpipe.init_state(jcfg)
    tstate = tpipe.init_state(cfg, device=CPU)
    base = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    poses, preds = [], []
    for frame in range(2):
        # the same scene seen again, so the second frame registers
        pts = base + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
        ts = rng.uniform(0, 1, n).astype(np.float32)
        rel = np.eye(4, dtype=np.float32)
        rel[0, 3] = 0.05 * frame
        preds.append(tstate.pose.numpy().astype(np.float64) @ rel)
        jstate, jout = step(jstate, jnp.asarray(pts), jnp.asarray(ts),
                            jnp.ones(n, bool), jnp.bool_(True), jnp.eye(4),
                            jnp.asarray(rel))
        tstate, tout = tpipe.register_frame(
            tstate, torch.from_numpy(pts), torch.from_numpy(ts),
            torch.ones(n, dtype=torch.bool), torch.tensor(True),
            torch.eye(4), torch.from_numpy(rel), cfg)
        diff = float(np.abs(tstate.pose.numpy()
                            - np.asarray(jstate.pose)).max())
        assert diff <= 1e-5
        poses.append(np.asarray(jstate.pose, np.float64))
        np.testing.assert_array_equal(tout.overflow.numpy(),
                                      np.asarray(jout.overflow))
        assert int(tout.debug.iterations) == int(jout.debug.iterations)
        assert int(tout.debug.num_correspondences) == int(
            jout.debug.num_correspondences)
        assert tout.debug.odometry_error_pt is None
    assert int(tout.debug.num_correspondences) > 100
    # the threshold took the se3 path in both packages
    sse_t = float(tstate.threshold.odom_sse)
    sse_j = float(jstate.threshold.odom_sse)
    assert abs(sse_t - sse_j) <= _sse_tolerance(poses, preds, jcfg.max_range,
                                                diff)
    assert float(tstate.threshold.num_samples) == pytest.approx(2.0)


@pytest.fixture(scope="module")
def exact_drive(drive):
    """The JAX drive under pruned-exact (V=14 with its certificate and
    full-27 fallback; JAX has it on the XLA lowering only)."""
    seq = drive[0]
    jcfg = DRIVE_CFG.replace(neighbor_candidates=27,
                             exact_gn_reassociation=True,
                             exact_prune_candidates=14)
    arrays = joffline.pad_sequence(seq["frames"][:FRAMES],
                                   seq["rel_odometry"][:FRAMES], jcfg)
    runner = joffline.make_sequence_runner(jcfg)
    _, jposes, jover, jfall = runner(
        jpipe.init_state(jcfg), *(jnp.asarray(a) for a in arrays[:4]),
        jnp.eye(4), jnp.asarray(arrays[4]))
    return seq, jcfg, np.asarray(jposes), np.asarray(jover), int(jfall)


def test_exact_drive_matches_jax(exact_drive):
    """15 frames: the port's pruned-exact runner has JAX's fallback total
    and overflow, and stays within 5 mm ATE of JAX; the port's full-27
    loop gives the same poses bit for bit, and its certified solve (the
    kernel's plain version on CPU tensors) stays within 5 mm."""
    seq, jcfg, jposes, jover, jfall = exact_drive
    frames, rels = seq["frames"][:FRAMES], seq["rel_odometry"][:FRAMES]
    cfg = _port_cfg(jcfg)
    runs = {}
    for name, over in (("pruned", {}),
                       ("full_27", dict(exact_prune_candidates=0)),
                       ("certified", dict(gn_backend="cuda"))):
        c = cfg.replace(**over)
        _, poses, over_t, fall = _port_run(c, frames, rels,
                                           tpipe.init_state(c, device=CPU))
        runs[name] = poses
        np.testing.assert_array_equal(over_t.numpy(), jover)
        assert ate_rmse(list(jposes), list(poses.numpy()), align=False) < 5e-3
        if name == "pruned":
            assert int(fall) == jfall  # the runner's fallback total
        elif name == "full_27":
            assert int(fall) == 0  # the plain loop has no certificate
    assert jfall > 0  # the certificate failed on some frames
    assert torch.equal(runs["pruned"], runs["full_27"])
    np.testing.assert_allclose(runs["pruned"].numpy()[:3], jposes[:3],
                               atol=1e-5)


def test_run_offline_return_stats(exact_drive):
    seq, jcfg, jposes, _, jfall = exact_drive
    poses, _, stats = toffline.run_offline(
        seq["frames"][:FRAMES], seq["rel_odometry"][:FRAMES],
        _port_cfg(jcfg), extrinsic=seq["extrinsic"], device=CPU,
        return_stats=True)
    assert stats["exact_fallback_frames"] == jfall
    np.testing.assert_array_equal(stats["overflow"], np.zeros(3, np.int32))
    assert ate_rmse(list(jposes), list(poses), align=False) < 5e-3


def test_certified_drive_matches_jax_solve_by_solve(drive, monkeypatch):
    """The certified branch along the port's own drive, at a 60 m range
    where the threshold reaches the voxel size and the certificate fails
    on some frames: every registration's inputs also go through JAX's
    certified composition (the Pallas kernel in interpret mode, the XLA
    full-27 loop where it crosses), which must agree frame by frame.

    Solve by solve and not as two runners: the threshold accumulates the
    ill-conditioned point-space error (ROADMAP C), so two trajectories
    whose tau sits near the voxel size can fall back on different frames.
    """
    seq = drive[0]
    frames = 6
    jcfg = DRIVE_CFG.replace(max_range=60.0, neighbor_candidates=27,
                             exact_gn_reassociation=True)
    cfg = _port_cfg(jcfg).replace(gn_backend="cuda")
    monkeypatch.setattr(pallas_gn, "gn_solve",
                        functools.partial(pallas_gn.gn_solve, interpret=True))
    solve = treg.compute_robot_motion
    fallbacks = []

    def both(m, source, mask, last, rel, tau, **kw):
        pose, dbg = solve(m, source, mask, last, rel, tau, **kw)
        jpose, jdbg = jreg.compute_robot_motion(
            jhm.MapState(table=jnp.asarray(_table(m)),
                         bucket_slots=m.bucket_slots),
            JP3(*(jnp.asarray(c.numpy()) for c in source)),
            jnp.asarray(mask.numpy()), jnp.asarray(last.numpy()),
            jnp.asarray(rel.numpy()), jnp.asarray(tau.numpy()),
            **{**kw, "gn_backend": "pallas"})
        assert bool(dbg.exact_fallback) == bool(jdbg.exact_fallback)
        assert int(dbg.iterations) == int(jdbg.iterations)
        assert int(dbg.num_correspondences) == int(jdbg.num_correspondences)
        diff = float(np.abs(pose.numpy() - np.asarray(jpose)).max())
        assert diff <= 1e-6
        guess = (last @ rel).numpy()
        assert abs(float(dbg.odometry_error_pt)
                   - float(jdbg.odometry_error_pt)) <= 1e-5 + \
            gn.error_tolerance(pose.numpy(), guess, jcfg.max_range,
                               diff + 5e-7)
        fallbacks.append(bool(dbg.exact_fallback))
        return pose, dbg

    monkeypatch.setattr(treg, "compute_robot_motion", both)
    _, _, _, total = _port_run(cfg, seq["frames"][:frames],
                               seq["rel_odometry"][:frames],
                               tpipe.init_state(cfg, device=CPU))
    assert len(fallbacks) == frames
    assert 0 < sum(fallbacks) < frames  # both halves of the branch ran
    # the runner's total: frame 0, the one the stationary gate masks,
    # has an empty map and passes
    assert int(total) == sum(fallbacks)


def test_state_from_numpy_continues_like_jax(drive):
    """The JAX state after 15 frames, carried into the port, gives the
    same pose on the next frame as the JAX step."""
    seq, jstate, _, _ = drive
    arrays = [a[0] for a in joffline.pad_sequence(
        seq["frames"][FRAMES:], seq["rel_odometry"][FRAMES:], DRIVE_CFG)]
    pts, ts, mask, has_ts, rel = arrays
    step = jpipe.make_step(DRIVE_CFG, donate=False)
    jnext, _ = step(jstate, jnp.asarray(pts), jnp.asarray(ts),
                    jnp.asarray(mask), jnp.asarray(has_ts), jnp.eye(4),
                    jnp.asarray(rel))

    numpy_state = (np.asarray(jstate.pose), np.asarray(jstate.map.table),
                   np.asarray(jstate.threshold.odom_sse),
                   np.asarray(jstate.threshold.num_samples))
    tstate = state_from_numpy(*numpy_state,
                              bucket_slots=DRIVE_CFG.max_probes, device=CPU)
    back = state_to_numpy(tstate)
    for a, b in zip(back, numpy_state):
        np.testing.assert_array_equal(a, b)
    tnext, _ = tpipe.register_frame(
        tstate, *(torch.from_numpy(np.asarray(a)) for a in (pts, ts, mask,
                                                            has_ts)),
        torch.eye(4), torch.from_numpy(rel), _port_cfg(DRIVE_CFG))
    np.testing.assert_allclose(tnext.pose.numpy(), np.asarray(jnext.pose),
                               atol=1e-5)
