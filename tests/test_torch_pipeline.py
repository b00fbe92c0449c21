"""Port vs JAX: one register_frame, a short drive, and state carried over."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu import offline as joffline
from kinematic_icp_tpu.models import pipeline as jpipe
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.convert import state_from_numpy, state_to_numpy
from kinematic_icp_tpu_torch.models import pipeline as tpipe
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
    return runner(state, *(torch.from_numpy(a) for a in arrays[:4]),
                  torch.eye(4), torch.from_numpy(arrays[4]))


def test_drive_matches_jax(drive):
    seq, _, jposes, jover = drive
    cfg = _port_cfg(DRIVE_CFG)
    _, tposes, tover = _port_run(cfg, seq["frames"][:FRAMES],
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
