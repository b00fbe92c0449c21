"""Port vs JAX: the two differential oracles (the float64 numpy
``OracleKinematicICP`` and the native C++ baseline), and the host helpers
of the same slice (visualization, profiling, the se3 helpers)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu import baseline_native as jbase
from kinematic_icp_tpu.ops import se3 as jse3
from kinematic_icp_tpu.ops.hashmap import MapState as JMapState
from kinematic_icp_tpu.oracle import OracleKinematicICP as JOracle
from kinematic_icp_tpu.utils import visualization as jvis
from kinematic_icp_tpu_torch import Config, baseline_native
from kinematic_icp_tpu_torch.convert import state_to_numpy
from kinematic_icp_tpu_torch.ops import se3
from kinematic_icp_tpu_torch.oracle import OracleKinematicICP
from kinematic_icp_tpu_torch.oracle.reference import se3_log
from kinematic_icp_tpu_torch.server import LidarOdometryServer
from kinematic_icp_tpu_torch.utils import profiling, synthetic, visualization
from kinematic_icp_tpu_torch.utils.io import native

torch.set_num_threads(1)

#: tests/test_differential.py's configuration
DIFF_CFG = dict(max_points=8192, max_downsampled=8192, max_source=4096,
                map_capacity=1 << 15, voxel_size=1.0, max_range=60.0,
                deskew=True)
#: tests/test_native.py:115-119
FIXED_CFG = dict(voxel_size=0.8, max_range=40.0, deskew=False,
                 use_adaptive_threshold=False, fixed_threshold=0.7,
                 use_adaptive_odometry_regularization=False,
                 fixed_regularization=0.1)


def _oracle_poses(oracle, seq, gate=True):
    """The oracle over the drive behind the server's stationary gate (as
    tests/test_native.py drives it); returns the per-frame poses."""
    poses = []
    for (p, t), rel in zip(seq["frames"], seq["rel_odometry"]):
        if not gate or np.linalg.norm(se3_log(rel)) > 1e-3:
            oracle.register_frame(p.astype(np.float64), t.astype(np.float64),
                                  seq["extrinsic"], rel)
        poses.append(oracle.last_pose.copy())
    return np.asarray(poses)


@pytest.mark.parametrize("cfg,frames,gate", [(DIFF_CFG, 8, True),
                                             (FIXED_CFG, 6, False)],
                         ids=["adaptive_deskew", "fixed_no_deskew"])
def test_oracle_equals_jax_frame_by_frame(cfg, frames, gate):
    seq = synthetic.make_sequence(frames, traj_seed=1 if gate else 5)
    ours = _oracle_poses(OracleKinematicICP(Config(**cfg)), seq, gate)
    theirs = _oracle_poses(JOracle(JConfig(**cfg)), seq, gate)
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, theirs, atol=1e-9, rtol=0)
    assert np.abs(ours[-1] - ours[0]).max() > 0.5  # the drive moved


def test_oracle_set_pose_and_threshold_like_jax():
    cfg = Config(**DIFF_CFG)
    ours, theirs = OracleKinematicICP(cfg), JOracle(JConfig(**DIFF_CFG))
    seq = synthetic.make_sequence(3)
    for o in (ours, theirs):
        _oracle_poses(o, seq)
    assert ours.compute_threshold() == theirs.compute_threshold()
    assert len(ours.local_map.pointcloud()) == len(
        theirs.local_map.pointcloud()) > 100
    seed = synthetic.planar_pose(1.0, -2.0, 0.3)
    for o in (ours, theirs):
        o.set_pose(seed)
    np.testing.assert_array_equal(ours.last_pose, theirs.last_pose)
    assert ours.local_map.empty() and ours.compute_threshold() == \
        theirs.compute_threshold()


def test_baseline_wire_format_equals_jax():
    seq = synthetic.make_sequence(3)
    args = (seq["frames"], seq["rel_odometry"], seq["extrinsic"])
    for kw in ({}, {"num_threads": 2, "apply_stationary_gate": False}):
        assert baseline_native.serialize_sequence(
            Config(**DIFF_CFG), *args, **kw) == jbase.serialize_sequence(
            JConfig(**DIFF_CFG), *args, **kw)


@pytest.mark.parametrize("cfg,frames,gate", [(DIFF_CFG, 15, True),
                                             (FIXED_CFG, 10, False)],
                         ids=["adaptive_deskew", "fixed_no_deskew"])
def test_baseline_equals_jax_and_the_oracle(cfg, frames, gate):
    """tests/test_native.py:106-125 for the port's own build of the
    baseline: equal to JAX's run of it and to the float64 oracle at
    1e-9."""
    if not jbase.available():
        pytest.skip("the JAX package's baseline binary is unavailable")
    seq = synthetic.make_sequence(frames, traj_seed=1 if gate else 5)
    args = (seq["frames"], seq["rel_odometry"], seq["extrinsic"])
    ours, stats = baseline_native.run_baseline(
        Config(**cfg), *args, apply_stationary_gate=gate)
    theirs, _ = jbase.run_baseline(JConfig(**cfg), *args,
                                   apply_stationary_gate=gate)
    assert stats["frames"] == frames
    np.testing.assert_allclose(ours, theirs, atol=1e-9, rtol=0)
    want = _oracle_poses(OracleKinematicICP(Config(**cfg)), seq, gate)
    np.testing.assert_allclose(ours, want, atol=1e-9, rtol=0)


def test_baseline_is_built_in_the_package():
    assert baseline_native.available()
    path = native.artifact_path("kicp_baseline")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.NATIVE_SRC.name == "native"


@pytest.fixture(scope="module")
def served():
    """A port server on the CPU after three frames of the drive."""
    seq = synthetic.make_sequence(3)
    s = LidarOdometryServer(Config(max_points=4096, max_downsampled=4096,
                                   max_source=1024, map_capacity=1 << 13,
                                   max_range=60.0, deskew=True),
                            extrinsic=seq["extrinsic"], device="cpu")
    for i, (p, t) in enumerate(seq["frames"]):
        s.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * (i + 1))
    return s


def test_export_map_debug_equals_jax_on_the_same_map(served, tmp_path):
    """The port's export reads its (NB, G*R) int32 table; JAX's, given the
    same table as uint32, writes the same two files."""
    visualization.export_map_debug(served, str(tmp_path / "port"))
    _, table, _, _ = state_to_numpy(served.state)
    jserver = types.SimpleNamespace(
        local_map_pointcloud=served.local_map_pointcloud,
        state=types.SimpleNamespace(map=JMapState(
            table=jnp.asarray(table), bucket_slots=served.config.max_probes)),
        config=served.config)
    jvis.export_map_debug(jserver, str(tmp_path / "jax"))
    for suffix in ("_local_map.ply", "_voxel_grid.ply"):
        ours = (tmp_path / f"port{suffix}").read_text()
        assert ours == (tmp_path / f"jax{suffix}").read_text()
    grid = (tmp_path / "port_voxel_grid.ply").read_text()
    assert int(grid.split("element edge ")[1].split()[0]) > 12 * 50


def test_ply_and_segments_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(20, 3)) * 5
    coords = rng.integers(-5, 5, (7, 3))
    np.testing.assert_array_equal(visualization.voxel_grid_segments(coords, 0.5),
                                  jvis.voxel_grid_segments(coords, 0.5))
    for mod, name in ((visualization, "port"), (jvis, "jax")):
        mod.write_ply(str(tmp_path / f"{name}.ply"), pts, color=(1, 2, 3))
        mod.write_voxel_grid_ply(str(tmp_path / f"{name}_grid.ply"), coords,
                                 0.5)
    for suffix in (".ply", "_grid.ply"):
        assert (tmp_path / f"port{suffix}").read_text() == (
            tmp_path / f"jax{suffix}").read_text()


def test_device_trace_writes_a_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    with profiling.device_trace(path) as prof:
        torch.ones(64).sum()
    assert prof.key_averages() is not None
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_se3_helpers_equal_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    xi = rng.normal(size=(5, 6)).astype(np.float32) * 0.5
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    tT = torch.from_numpy(T)
    R, t = T[:, :3, :3], T[:, :3, 3]

    def close(ours, theirs, atol=1e-6):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=atol, rtol=0)

    close(se3.hat(torch.from_numpy(w)), jse3.hat(jnp.asarray(w)), 0)
    close(se3.vee(se3.hat(torch.from_numpy(w))), w, 0)
    close(se3.from_rt(torch.from_numpy(R), torch.from_numpy(t)),
          jse3.from_rt(jnp.asarray(R), jnp.asarray(t)), 0)
    close(se3.from_rt(torch.from_numpy(R[0]), torch.from_numpy(t)),
          jse3.from_rt(jnp.asarray(R[0]), jnp.asarray(t)), 0)
    close(se3.identity(batch_shape=(2,)),
          jse3.identity(batch_shape=(2,)), 0)
    close(se3.compose(tT, tT), jse3.compose(jnp.asarray(T), jnp.asarray(T)))
    close(se3.apply(tT, torch.from_numpy(pts)),
          jse3.apply(jnp.asarray(T), jnp.asarray(pts)), 1e-5)
    q = se3.to_quaternion(tT)
    close(q, jse3.to_quaternion(jnp.asarray(T)))
    close(se3.from_quaternion(q, torch.from_numpy(t)),
          jse3.from_quaternion(jnp.asarray(q.numpy()), jnp.asarray(t)))
    close(se3.from_quaternion(q), jse3.from_quaternion(jnp.asarray(
        q.numpy())))


#: chip_smoke.py's headline configuration
HEADLINE = dict(max_points=65536, max_downsampled=8192, max_source=1024,
                map_capacity=5 << 14, max_probes=5, voxel_size=1.0,
                max_range=60.0, deskew=True)


@pytest.mark.slow
def test_headline_drive_baseline_divergence(capsys):
    """The 60 headline frames of ``chip_smoke.py`` (~40 s on the CPU):
    the native baseline's distance to the JAX package's drive and to the
    port's, beside the baseline's own self-divergence on the drive (the
    draws of tests/test_differential.py:91-115).  Prints one JSON line of
    unaligned ATEs in metres; run with ``-m slow -s``."""
    import json

    from kinematic_icp_tpu.offline import run_offline as jax_run_offline
    from kinematic_icp_tpu_torch.offline import run_offline
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    n = 60
    seq = synthetic.make_sequence(n, lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    frames, rels, ext = seq["frames"], seq["rel_odometry"], seq["extrinsic"]
    cfg = Config(**HEADLINE)

    def ate(a, b):
        return ate_rmse(list(a), list(b), align=False)

    base, _ = baseline_native.run_baseline(cfg, frames, rels, ext)
    rng = np.random.default_rng(7)
    draws = [[(p + rng.normal(0, 1e-6, p.shape), t) for p, t in frames]]
    for d in range(2):
        rng = np.random.default_rng(777 + d)
        perms = [rng.permutation(len(p)) for p, _ in frames]
        draws.append([(p[i], t[i]) for (p, t), i in zip(frames, perms)])
    floors = [ate(base, baseline_native.run_baseline(cfg, d, rels, ext)[0])
              for d in draws]
    port, _ = run_offline(frames, rels, cfg, extrinsic=ext, device="cpu")
    jax, _ = jax_run_offline(frames, rels, JConfig(**HEADLINE),
                             extrinsic=ext)
    jax = np.asarray(jax, np.float64)
    res = {"frames": n, "baseline_self_divergence_m": floors,
           "port_cpu_vs_baseline_m": ate(base, port),
           "jax_cpu_vs_baseline_m": ate(base, jax),
           "jax_cpu_vs_port_cpu_m": ate(jax, port),
           "baseline_vs_gt_m": ate(seq["gt_poses"], base)}
    with capsys.disabled():
        print(json.dumps(res))
    bound = max(0.05, 3.5 * max(floors))
    assert res["jax_cpu_vs_port_cpu_m"] < 5e-3
    assert res["port_cpu_vs_baseline_m"] <= bound
    assert res["jax_cpu_vs_baseline_m"] <= bound
