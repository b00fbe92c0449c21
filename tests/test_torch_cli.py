"""Port vs JAX: the offline CLI (bag -> TUM) and the evaluation CLI, on a
bag written by the JAX package's writer (tests/test_run_odometry.py's
drive and settings)."""

import json
import os

import numpy as np
import pytest
import torch

from kinematic_icp_tpu import evaluate as jevaluate
from kinematic_icp_tpu import run_odometry as jrun
from kinematic_icp_tpu.utils import synthetic as jsyn
from kinematic_icp_tpu_torch import evaluate, run_odometry
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse
from kinematic_icp_tpu_torch.utils.io.tum import read_tum, write_tum

torch.set_num_threads(1)

#: tests/test_run_odometry.py:14-30
NUM_FRAMES = 15
ARGS = ["--max-points", "8192", "--no-progress"]
#: tests/test_torch_server.py: the first frames solve alike to 1e-5, the
#: whole drive (the servers drift apart by float rounding after ~8 frames)
#: within 5 mm ATE
POSE_TOL = 1e-5
DRIVE_ATE = 5e-3


@pytest.fixture(scope="module")
def bag(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "drive.mcap")
    seq = jsyn.make_sequence(NUM_FRAMES)
    jsyn.write_sequence_to_mcap(seq, path, scan_2d_topic="/front_scan")
    return path, seq


@pytest.fixture(scope="module")
def both_runs(bag, tmp_path_factory):
    """JAX's CLI and the port's (``--device cpu``) on the same bag."""
    path, _ = bag
    jdir = tmp_path_factory.mktemp("jax_out")
    tdir = tmp_path_factory.mktemp("port_out")
    jout = jrun.main([path, *ARGS, "--output-dir", str(jdir)])
    tout = run_odometry.main([path, *ARGS, "--output-dir", str(tdir),
                              "--device", "cpu"])
    return jout, tout


def _dead_reckoning(seq):
    dead = [np.eye(4)]
    for rel in seq["rel_odometry"][1:]:
        dead.append(dead[-1] @ rel)
    return dead


def test_port_cli_matches_jax_cli(bag, both_runs):
    _, seq = bag
    jout, tout = both_runs
    assert os.path.basename(tout) == os.path.basename(jout) == \
        "drive_kinematic_icp_poses_tum.txt"
    with open(jout) as f:
        jlines = f.read().splitlines()
    with open(tout) as f:
        tlines = f.read().splitlines()
    assert len(tlines) == len(jlines) == NUM_FRAMES
    # the stamp column, byte for byte
    assert [ln.split()[0] for ln in tlines] == [ln.split()[0] for ln in jlines]
    _, jposes = read_tum(jout)
    _, tposes = read_tum(tout)
    np.testing.assert_allclose(np.asarray(tposes[:4]), np.asarray(jposes[:4]),
                               atol=POSE_TOL, rtol=0)
    assert ate_rmse(jposes, tposes, align=False) < DRIVE_ATE
    # tests/test_run_odometry.py:33-45
    ate = ate_rmse(seq["gt_poses"], tposes, align=False)
    ate_dead = ate_rmse(seq["gt_poses"], _dead_reckoning(seq), align=False)
    assert ate < max(0.05, ate_dead), (ate, ate_dead)


@pytest.fixture(scope="module")
def five_frames(bag, tmp_path_factory):
    """The port's CLI over the first five frames, with the viewer."""
    path, _ = bag
    d = tmp_path_factory.mktemp("five")
    out = run_odometry.main([path, "--max-frames", "5", "--output-dir",
                             str(d), *ARGS, "--visualize", "--device",
                             "cpu"])
    return out, d


def test_max_frames(five_frames):
    stamps, poses = read_tum(five_frames[0])
    assert len(poses) == 5 and np.all(np.isfinite(stamps))


def test_visualize_writes_standalone_html(five_frames):
    html = five_frames[1] / "drive_kinematic_icp_view.html"
    text = html.read_text()
    assert "http" not in text.split("<script>")[1]
    assert '"local_map"' in text and '"trajectory"' in text


def test_2d_lidar_drive(bag, tmp_path):
    """tests/test_aux.py:36-51 (over 8 of its 12 frames): the LaserScan
    topic of the same world."""
    path, seq = bag
    frames = 8
    out = run_odometry.main([path, "--use-2d-lidar", "--lidar-topic",
                             "/front_scan", "--output-dir", str(tmp_path),
                             "--max-points", "4096", "--no-progress",
                             "--max-frames", str(frames), "--device", "cpu"])
    _, poses = read_tum(out)
    assert len(poses) == frames
    ate = ate_rmse(seq["gt_poses"][:frames], poses, align=False)
    ate_dead = ate_rmse(seq["gt_poses"][:frames],
                        _dead_reckoning(seq)[:frames], align=False)
    assert ate < max(0.08, 1.2 * ate_dead), (ate, ate_dead)


def test_config_yaml_sets_the_configuration(bag, tmp_path):
    yaml = pytest.importorskip("yaml")
    path, _ = bag
    cfg = tmp_path / "params.yaml"
    cfg.write_text(yaml.safe_dump({"kinematic_icp_offline_node": {
        "ros__parameters": {"max_range": 60.0, "deskew": True,
                            "max_source": 1024, "map_capacity": 1 << 14}}}))
    out = run_odometry.main([path, "--config", str(cfg), "--max-frames", "3",
                             "--output-dir", str(tmp_path), *ARGS,
                             "--device", "cpu"])
    assert len(read_tum(out)[1]) == 3


def test_cli_needs_a_card_unless_told_cpu(bag, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    path, _ = bag
    with pytest.raises(RuntimeError, match="CUDA"):
        run_odometry.main([path, *ARGS, "--output-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_evaluate_gives_jax_numbers(bag, both_runs, tmp_path, capsys):
    _, seq = bag
    jout, tout = both_runs
    stamps, _ = read_tum(tout)
    gt = str(tmp_path / "gt.txt")
    write_tum(gt, list(zip(stamps, seq["gt_poses"])))
    for est in (tout, jout):
        for extra in ([], ["--no-align", "--rpe-delta", "2"]):
            ours = evaluate.main([est, gt, *extra, "--json"])
            theirs = jevaluate.main([est, gt, *extra, "--json"])
            assert ours == theirs
            lines = capsys.readouterr().out.splitlines()
            assert json.loads(lines[0]) == json.loads(lines[1]) == ours
    r = evaluate.evaluate_files(tout, gt, align=False)
    assert r["matched_poses"] == NUM_FRAMES and r["ate_rmse_m"] < 0.05


def test_evaluate_cli_offset_stamps(tmp_path, capsys):
    """tests/test_run_odometry.py:68-91 on the port's CLI."""
    rng = np.random.default_rng(0)
    poses, ref = [], []
    T = np.eye(4)
    for i in range(30):
        T = T.copy()
        T[0, 3] += 0.1
        ref.append((float(i) * 0.1, T))
        Te = T.copy()
        Te[:3, 3] += rng.normal(0, 0.01, 3)
        poses.append((float(i) * 0.1 + 0.003, Te))
    write_tum(str(tmp_path / "ref.txt"), ref)
    write_tum(str(tmp_path / "est.txt"), poses)
    r = evaluate.main([str(tmp_path / "est.txt"), str(tmp_path / "ref.txt"),
                       "--no-align"])
    assert r == jevaluate.main([str(tmp_path / "est.txt"),
                                str(tmp_path / "ref.txt"), "--no-align"])
    assert r["matched_poses"] == 30 and 0 < r["ate_rmse_m"] < 0.05
    assert "ATE RMSE" in capsys.readouterr().out
    with pytest.raises(ValueError, match="stamp matches"):
        evaluate.evaluate_files(str(tmp_path / "est.txt"),
                                str(tmp_path / "ref.txt"),
                                max_stamp_diff=1e-4)


def test_bag_written_by_either_package_is_the_same(bag, tmp_path):
    path, seq = bag
    ours = str(tmp_path / "drive.mcap")
    synthetic.write_sequence_to_mcap(seq, ours, scan_2d_topic="/front_scan")
    with open(ours, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
