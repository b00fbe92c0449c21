"""The harness: lookup by name, the contract's shape, a cell and a driver
added as files, the module check, the GN bound's bytes, open-loop latency
and the refusal to run without a card."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import BENCH, BENCH_DIRS, ROOT, SECONDS, SEED

from icp_bench.core import harness, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files_and_readers_by_name():
    bench = _benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert isinstance(harness.load_driver(cell.traffic["driver"]), type)
        assert set(cell.limits) == {"pose_gap_m", "overflow"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
    with pytest.raises(harness.CellError):
        harness.find_cell(bench, "no.such.cell")


def test_benchmark_json_keeps_the_contract_shape():
    bench = _benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["icp_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "icp_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        names.add(c["name"])
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == names
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_added_as_files_runs_without_editing_any(tiny_bench,
                                                        tmp_path):
    """The tiny cells are new configuration, traffic and limit files plus
    new entries; a copy of the benchmark's own files stays byte-equal
    after they run, traced and not."""
    bench, tmp = tiny_bench
    before = {d: _digest(BENCH / d) for d in BENCH_DIRS}
    for traced in (False, True):
        r = harness.run_cell(bench, "tiny.live", SEED, SECONDS, traced,
                             "cpu", time.perf_counter(), tmp,
                             log=open(os.devnull, "w"))
        assert r["correct"], r["checks"]
        assert r["attempted"] == 12
        assert list(r)[-1] == "checks"
        if traced:
            assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
            assert r["metrics"] == {}  # no device events on the CPU
        else:
            # the driver's p95 is no end-to-end metric of the cell
            assert set(r["metrics"]) == {"latency_p50_ms", "setup_s"}
    for d, digest in before.items():
        assert _digest(BENCH / d) == digest
        copied = _digest(tmp / d)
        assert {k: v for k, v in copied.items() if k in digest} == digest


#: a driver of a mix the benchmark does not have: one sensor's scans
#: through ``register_frame`` back to back, a closed loop
CLOSED_LOOP = '''
import time

import numpy as np

from icp_bench.core import driving, generate
from icp_bench.core.trace import SPAN_FRAME


class Driver:
    units_per_span = 1

    def __init__(self, config, traffic, seed, seconds, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device

    def prepare_inputs(self):
        self.drive = generate.drives(
            self.seed, 1, int(self.traffic["frames"]),
            self.config["sensor"], self.config["world"],
            float(self.traffic["speed_m_per_frame"]), self.device)[0]

    def input_frames(self):
        return [(self.drive, len(self.drive["frames"]))]

    def prepare(self):
        from kinematic_icp_tpu_torch.server import LidarOdometryServer
        self.prepare_inputs()
        self.server = LidarOdometryServer(
            driving.port_config(self.config, self.device),
            extrinsic=self.drive["extrinsic"], device=self.device)
        self.poses = []

    def measure(self, traced=None):
        t0 = time.perf_counter()
        for i, (pts, ts) in enumerate(self.drive["frames"]):
            with driving.span(traced, SPAN_FRAME, i):
                out = self.server.register_frame(
                    pts, ts, self.drive["rel_odometry"][i], blocking=True)
            self.poses.append(out["pose"])
        return t0, time.perf_counter()

    def frames(self):
        return len(self.poses)

    def metrics(self, start, end):
        return {"frames_per_s": (len(self.poses) / (end - start),
                                 "frames/s")}

    def notes(self):
        return {}

    def answers(self):
        return [(self.drive, np.asarray(self.poses),
                 int(sum(self.server.overflow_stats.values())))]

    def release(self):
        del self.server
'''


def test_a_mix_with_a_driver_of_its_own_is_added_as_files(tiny_bench,
                                                          tmp_path):
    """A new loop is a new ``drivers/<name>.py`` and a mix naming it: the
    cell runs, traced and not, and no file that was there changes."""
    bench, tmp = tiny_bench
    bench = json.loads(json.dumps(bench))
    root = tmp_path / "bench"
    shutil.copytree(tmp, root)
    before = _digest(root)
    (root / "drivers" / "closed_tiny.py").write_text(CLOSED_LOOP)
    (root / "traffic" / "closed_tiny.json").write_text(json.dumps(
        {"driver": "closed_tiny", "frames": 6, "speed_m_per_frame": 0.2,
         "traced": [1, 4]}))
    shutil.copy(root / "cells" / "tiny.live.json",
                root / "cells" / "tiny.closed.json")
    bench["workloads"].append({"name": "tiny.closed",
                               "config": "ros_default_tiny",
                               "traffic": "closed_tiny", "chips": 1,
                               "why": "a CPU test's size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s", "device_ms.live"):
            m["workloads"].append("tiny.closed")
    for traced in (False, True):
        r = harness.run_cell(bench, "tiny.closed", SEED, SECONDS, traced,
                             "cpu", time.perf_counter(), root,
                             log=open(os.devnull, "w"))
        assert r["correct"], r["checks"]
        assert r["attempted"] == 6
        if not traced:
            assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_forbidden_modules_compare_whole_top_level_names():
    ok = {"kinematic_icp_tpu_torch", "kinematic_icp_tpu_torch.ops.gn",
          "jaxtyping", "numpy", "flaxen"}
    assert harness.forbidden_modules(ok) == []
    bad = {"jax.numpy", "jaxlib", "flax.linen", "kinematic_icp_tpu.ops"}
    assert harness.forbidden_modules(ok | bad) == sorted(bad)


def test_the_gn_bound_counts_the_bytes_of_both_shapes():
    # V = 10: 6,553,600 words + 327,680 ids + 98,304 bases + 98,304
    # sources + 8,192 mask + 68 guess and tau + 77 outputs
    assert roofline.gn_bytes(10, 20, 8192) == 7_086_225
    assert roofline.gn_bytes(27, 20, 8192) == 18_784_401
    assert roofline.gn_bound_bytes(10, 20, 8192, 1) == pytest.approx(
        2.11529e-6, rel=1e-5)
    assert roofline.gn_bound_bytes(27, 20, 8192, 8) == pytest.approx(
        8 * 18_784_401 / 3.35e12)


class _StallingServer:
    """Returns at once, except frame ``stall_at``, which takes ``stall``
    seconds."""

    def __init__(self, stall_at, stall):
        self.stall_at, self.stall, self.k = stall_at, stall, 0
        self.overflow_stats = {}

    def register_frame(self, *args, **kwargs):
        if self.k == self.stall_at:
            time.sleep(self.stall)
        self.k += 1
        return {"pose": np.eye(4)}


def test_open_loop_latency_runs_from_the_due_time():
    """A 0.33 s stall at 20 Hz delays the six frames due during it: each
    is timed from its own due time, not from when it was sent."""
    live = harness.load_driver("live")(
        {}, {"rate_hz": 20.0, "warmup_frames": 0}, 0, 2.0, "cpu")
    live.drive = {"frames": [(None, None)] * 40,
                  "rel_odometry": [None] * 40}
    live.server = _StallingServer(stall_at=10, stall=0.33)
    live.poses = []
    start, end = live.measure()
    lat = np.asarray(live.latency)
    assert len(lat) == 40
    assert lat[10] >= 0.33
    for j in range(1, 7):  # due 50 ms apart, all waiting on frame 10
        assert lat[10 + j] == pytest.approx(0.33 - 0.05 * j, abs=0.02)
    assert lat[17] < 0.02 and np.median(lat) < 0.01
    m = live.metrics(start, end)
    assert m["latency_p95_ms"][0] >= 200.0  # two of 40 wait 0.28 s or more
    notes = live.notes()
    assert notes["send_late_ms_max"] >= 0.25 * 1e3
    assert notes["slowest_ms_late_ms_switches"][0][0] >= 330.0


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "icp_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


ARGS = ["--workload", "ros_default.live10hz", "--seed", str(SEED),
        "--seconds", "1", "--trace", "0"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ARGS, ROOT, env)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA card" in r.stderr


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "icp_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(ARGS, tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""


def test_the_breakdown_sums_device_ops_and_names_idle_gaps():
    from icp_bench.core import trace
    tr = trace.Trace(
        config={}, traffic={},
        device=[("k1", 0, 10), ("k2", 5, 20), ("k1", 40, 50),
                ("k2", 90, 100)],
        host=[("pack", 18, 45), ("wait", 60, 95), ("inner", 62, 80)],
        spans=[("icp_bench.frame", 0, 100)], window=(0, 100), units=1)
    b = trace.breakdown(tr)
    assert b["device_ops"] == [["k2", 25e-9], ["k1", 20e-9]]
    # gaps: 20-40 (mid 30, in "pack"), 50-90 (mid 70, in "inner")
    assert b["idle_gaps"] == [["inner", 40e-9], ["pack", 20e-9]]
    assert trace.busy_ns(tr.device, 0, 100) == 40


def test_the_gn_share_is_the_bytes_bound_over_the_launches_time():
    from icp_bench.core import trace
    cfg = {"config": {"exact_gn_reassociation": True,
                      "neighbor_candidates": 27, "max_points_per_voxel": 20,
                      "max_source": 8192}}
    bound_ns = 8 * 18_784_401 / 3.35e12 * 1e9       # 44.86 us
    dev = [("void gn_solve_kernel<true>(...)", 0, 90_000),
           ("other", 0, 500_000),
           ("void gn_solve_kernel<true>(...)", 200_000, 290_000)]
    tr = trace.Trace(config=cfg, traffic={"lanes": 8}, device=dev, host=[],
                     spans=[], window=(0, 300_000), units=2)
    assert roofline.gn_share(tr) == pytest.approx(100 * bound_ns / 90_000)
    tr.device = dev[1:2]
    assert roofline.gn_share(tr) is None
