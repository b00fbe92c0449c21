"""The offline node's cell, ``ros_offline_bag.bag300``, at a size the CPU
runs: a tiny copy of the cell added as files and entries runs through the
``bag`` driver (a bag written, ``run_odometry.main`` pass after pass) and
reads ``correct``; a program that gives no overflow total fails at set-up;
faults planted in the ingestion layer read ``correct`` false; the readers
of the new spans."""

from __future__ import annotations

import copy
import json
import os
import time

import pytest
from conftest import BENCH, BENCH_DIRS, SEED, TINY_CONFIG, TINY_SENSOR

from icp_bench.core import harness
from icp_bench.core.trace import Trace

CELL = "ros_offline_bag.bag300"
MS = 1_000_000  # ns
#: the tiny cells' ``pose_gap_m`` limit: the 256-column, 12-ring cut
#: registers coarser than the 32-ring sensor the cell's limit was set on
#: (sound 48-scan drives part from the reference by 0.75-30.1 mm over four
#: seeds on the CPU, this test's seed the 30.1; the two planted faults by
#: 57.7-121.0 mm), so the cut takes a limit between those readings
TINY_LIMIT_M = 0.045
READERS = ("read_ms.bag", "decode_ms.bag", "tf_ms.bag")
#: the offline cells' device readers, which read a pass of this cell too
OFFLINE = ("idle_share.offline", "h2d_ms.offline",
           "gn_solve_roofline.offline")


def _dump(obj, path):
    path.write_text(json.dumps(obj, indent=1) + "\n")


def _add_cell(bench, tmp, name, frames, config=None):
    """``name``: the cell cut to the tiny sensor and ``frames`` scans, as
    new files and entries."""
    c = json.loads((tmp / "configs" / "ros_offline_bag.json").read_text())
    c["name"] = f"bag_{name}"
    sizes = {**TINY_CONFIG, **(config or {})}
    c["config"].update(sizes)
    c["sensor"].update(TINY_SENSOR)
    c["bag"]["parameters"].update(
        {k: v for k, v in sizes.items() if k != "max_points"})
    _dump(c, tmp / "configs" / f"bag_{name}.json")
    t = json.loads((tmp / "traffic" / "bag300.json").read_text())
    t.update({"frames": frames, "traced": [0, 1]})
    _dump(t, tmp / "traffic" / f"bag_{name}.json")
    bench["workloads"].append({"name": name, "config": f"bag_{name}",
                               "traffic": f"bag_{name}", "chips": 1,
                               "why": "a CPU test's size"})
    limits = json.loads((tmp / "cells" / f"{CELL}.json").read_text())
    limits["pose_gap_m"]["limit"] = TINY_LIMIT_M
    _dump(limits, tmp / "cells" / f"{name}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(name)


@pytest.fixture(scope="module")
def bag_bench(tiny_bench):
    """The tiny benchmark with ``tiny.bag`` (8 scans) and ``tiny.bag48``
    (48 scans, a map table to hold them)."""
    bench, tmp = tiny_bench
    bench = copy.deepcopy(bench)
    _add_cell(bench, tmp, "tiny.bag", 8)
    _add_cell(bench, tmp, "tiny.bag48", 48, {"map_capacity": 1 << 16})
    return bench, tmp


def _run(bag_bench, cell, traced=False, seconds=0.1, seed=SEED):
    bench, tmp = bag_bench
    return harness.run_cell(bench, cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), tmp,
                            log=open(os.devnull, "w"))


def test_the_cell_finds_its_files_and_readers():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, CELL)
    assert cell.traffic["driver"] == "bag"
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS + OFFLINE)
    # uncompressed chunks: the card's host has no zstandard
    assert cell.config["bag"]["compression"] == ""
    assert cell.config["reduced"] == ["bag.compression"]


def test_the_tiny_cell_runs_traced_and_not(bag_bench):
    before = {d: sorted(p.name for p in (BENCH / d).iterdir())
              for d in BENCH_DIRS}
    for traced in (False, True):
        r = _run(bag_bench, "tiny.bag", traced)
        assert r["correct"], r["checks"]
        # whole passes of 8 scans, the first in the trace
        assert r["attempted"] >= 8 and r["attempted"] % 8 == 0
        assert r["checks"]["overflow"]["value"] == 0
        if traced:
            assert r["metrics"] == {}  # no device events on the CPU
            assert r["device"]["window_s"] > 0
        else:
            assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert {d: sorted(p.name for p in (BENCH / d).iterdir())
            for d in BENCH_DIRS} == before


def test_a_program_without_the_overflow_total_fails_at_set_up(
        bag_bench, monkeypatch):
    """The program before the cell: ``run_odometry.run`` hands out no
    overflow total, and the run stops in set-up instead of guessing 0."""
    from kinematic_icp_tpu_torch import run_odometry
    run = run_odometry.run

    def without(args, timings=None):
        out = run(args, timings)
        timings.pop("overflow")
        return out

    monkeypatch.setattr(run_odometry, "run", without)
    with pytest.raises(RuntimeError, match="overflow"):
        _run(bag_bench, "tiny.bag")


def test_the_sound_program_is_correct_on_the_longer_drive(bag_bench):
    r = _run(bag_bench, "tiny.bag48")
    assert r["correct"], r["checks"]


def test_per_point_times_dropped_read_false(bag_bench, monkeypatch):
    """The decode drops the scans' per-point times: no deskew."""
    from kinematic_icp_tpu_torch.utils.io import timestamps
    decode = timestamps.decode_scan
    monkeypatch.setattr(timestamps, "decode_scan",
                        lambda msg: decode(msg)._replace(timestamps=None))
    r = _run(bag_bench, "tiny.bag48")
    assert not r["correct"]
    assert r["checks"]["overflow"]["value"] == 0


def test_the_extrinsic_ignored_reads_false(bag_bench, monkeypatch):
    """The server keeps the identity for the base -> lidar transform
    /tf_static gives it."""
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    prop = LidarOdometryServer.extrinsic
    monkeypatch.setattr(LidarOdometryServer, "extrinsic",
                        property(prop.fget, lambda self, value: None))
    r = _run(bag_bench, "tiny.bag48")
    assert not r["correct"]
    assert r["checks"]["overflow"]["value"] == 0


def _trace(host, device=(("k", 1 * MS, 2 * MS),), config=None,
           traffic=None):
    return Trace(config=config or {}, traffic=traffic or {},
                 device=list(device), host=host,
                 spans=[("icp_bench.pass", 0, 10 * MS)],
                 window=(0, 10 * MS), units=2)


def test_the_readers_sum_each_span_over_the_frames():
    host = [("kicp.bag_read", 0, 1 * MS), ("kicp.bag_read", 5 * MS, 6 * MS),
            ("kicp.bag_read", 9.5 * MS, 11 * MS),     # cut at the window
            ("kicp.decode", 1 * MS, 1.5 * MS),
            ("kicp.decode", 6 * MS, 7 * MS),
            ("kicp.tf_lookup", 1.5 * MS, 1.7 * MS),
            ("kicp.tf_lookup", 7 * MS, 7.2 * MS)]
    read = {name: harness.load_reader(name)(_trace(host))
            for name in READERS + ("idle_share.offline",)}
    assert read["read_ms.bag"] == pytest.approx(2.5 / 2)
    assert read["decode_ms.bag"] == pytest.approx(1.5 / 2)
    assert read["tf_ms.bag"] == pytest.approx(0.4 / 2)
    assert read["idle_share.offline"] == pytest.approx(90.0)


def test_the_offline_device_readers_read_a_pass_one_frame_a_launch():
    """A pass's units are its frames, and its traffic names no lanes:
    ``h2d_ms.offline`` is the upload's device ms a frame and
    ``gn_solve_roofline.offline`` bounds one frame a launch at the
    configuration's candidate voxels."""
    from icp_bench.core import roofline
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, CELL)
    device = [("Memcpy HtoD (Pageable -> Device)", 1 * MS, 1.5 * MS),
              ("Memcpy HtoD (Pageable -> Device)", 6 * MS, 6.3 * MS),
              ("gn_solve_kernel", 2 * MS, 2.02 * MS),
              ("gn_solve_kernel", 7 * MS, 7.03 * MS)]
    tr = _trace([], device, cell.config, cell.traffic)
    assert harness.load_reader("h2d_ms.offline")(tr) == pytest.approx(
        0.8 / 2)
    c = cell.config["config"]
    bound = roofline.gn_bound_bytes(c["neighbor_candidates"],
                                    c["max_points_per_voxel"],
                                    c["max_source"], 1)
    assert harness.load_reader("gn_solve_roofline.offline")(tr) == \
        pytest.approx(100.0 * bound * 2 / 0.05e-3)


def test_the_readers_find_nothing_in_a_program_without_the_spans():
    """A program without these spans records no ``kicp.bag_read`` and
    the like; a CPU run no device activity."""
    spans = {"read_ms.bag": "kicp.bag_read", "decode_ms.bag": "kicp.decode",
             "tf_ms.bag": "kicp.tf_lookup"}
    for name, span in spans.items():
        reader = harness.load_reader(name)
        assert reader(_trace([("kicp.register_frame", 0, MS)])) is None
        assert reader(_trace([(span, 0, MS)], device=())) is None
        assert reader(_trace([(span, 0, MS)])) == pytest.approx(0.5)
