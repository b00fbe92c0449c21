"""The plain reference against the program's CPU path, and the control
that the comparison has to fail."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, SEED, TINY_CONFIG, TINY_SENSOR

from icp_bench import control
from icp_bench.core import generate, harness
from icp_bench.reference import kicp


def _tiny(name):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c["config"].update(TINY_CONFIG)
    c["sensor"].update(TINY_SENSOR)
    return c


def _drive(c, frames):
    return generate.drives(SEED, 1, frames, c["sensor"], c["world"], 0.2)[0]


def test_downsample_keeps_the_programs_points_and_order():
    from kinematic_icp_tpu_torch.ops import voxel
    from kinematic_icp_tpu_torch.ops.points import P3
    pts, _ = _drive(_tiny("ros_default"), 2)["frames"][1]
    p = torch.from_numpy(pts)
    for size in (0.5, 1.5):
        ours = kicp.downsample(p.double(), size).float()
        planes, mask, dropped = voxel.voxel_downsample(
            P3.from_array(p), torch.ones(len(p), dtype=torch.bool), size,
            len(p), max_extent=200.0)
        theirs = torch.stack([planes.x, planes.y, planes.z], -1)[mask]
        assert int(dropped) == 0
        assert torch.equal(ours, theirs)


def _quantised_add(add):
    """``VoxelMap.add`` storing each point at the centre of its cell of the
    program's map grid (1/1024 of a voxel a side)."""
    def quantised(self, world):
        vs = self.voxel_size
        base = torch.floor(world / vs)
        cell = torch.clamp(torch.floor((world - base * vs) * 1024 / vs), 0,
                           1023)
        add(self, base * vs + (cell + 0.5) * vs / 1024)
    return quantised


@pytest.mark.parametrize("name", ["ros_default", "ros_exact"])
def test_the_reference_follows_the_program(name, monkeypatch):
    """Given the program's map grid, the reference follows the program to
    float32 rounding; with exact map points it stays within millimetres
    (the comparison's lower reading carries that)."""
    from kinematic_icp_tpu_torch.config import Config
    from kinematic_icp_tpu_torch.offline import run_offline
    c = _tiny(name)
    d = _drive(c, 6)
    fields = dict(c["config"], gn_backend="auto")
    poses, _ = run_offline(d["frames"], d["rel_odometry"], Config(**fields),
                           device="cpu")
    cfg = {**c["config"], **c["reference"]}
    exact = kicp.run_drive(d, cfg, "cpu")
    monkeypatch.setattr(kicp.VoxelMap, "add",
                        _quantised_add(kicp.VoxelMap.add))
    gridded = kicp.run_drive(d, cfg, "cpu")
    assert np.abs(poses - gridded).max() < 2e-5
    assert np.abs(poses - exact).max() < 5e-3
    assert np.linalg.norm(exact[-1, :3, 3]) > 0.5


def test_the_tf32_control_reads_far_above_the_program(tiny_bench):
    """On the tiny live cell's inputs, TF32 in the program's place reads a
    gap several times the program's own."""
    bench, tmp = tiny_bench
    prog = harness.run_cell(bench, "tiny.live", SEED, 0.6, False, "cpu",
                            time.perf_counter(), tmp,
                            log=open("/dev/null", "w"))
    _, numbers = control.readings(bench, "tiny.live", SEED, 0.6, "cpu",
                                  tmp)
    assert numbers["pose_gap_m"]["value"] >= 3 * \
        prog["checks"]["pose_gap_m"]["value"]


def test_tf32_rounds_to_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11,
                      1 + 2**-11 + 2**-20, -3.0])
    got = kicp.tf32(x)
    want = torch.tensor([1.0, 1 + 2**-10, 1.0, 1 + 2**-9,
                         1 + 2**-10, -3.0])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ros_default.live10hz",
                                      "ros_exact.offline8"])
def test_the_control_fails_each_cell_at_its_size(workload):
    """On the card: TF32 in the program's place, at the cell's own
    inputs, reads ``correct`` false."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "size")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    correct, numbers = control.readings(bench, workload, SEED, 30.0,
                                        "cuda")
    assert not correct, numbers
