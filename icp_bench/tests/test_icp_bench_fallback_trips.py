"""The reader of ``fallback_trips.offline``: the full-27 loop's trips a
fallback lane-frame, from the program's ``gn`` samples (their
``fallback_trips`` over their ``fallbacks``) in the traced window; nothing
without device events or from a program whose samples carry no trips."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from icp_bench.core import harness
from icp_bench.core.trace import Trace
from kinematic_icp_tpu_torch.utils import profiling

NAME = "fallback_trips.offline"
MS = 1_000_000  # ns


@pytest.fixture
def gn_samples():
    profiling._buffer.clear()

    def seed(*samples):
        for t, values in samples:
            profiling._buffer.append(("gn", t, values))

    yield seed
    profiling._buffer.clear()


def _gn(fallbacks, trips=None):
    got = {"frames": 400, "passes": 1200, "sources": 400 * 4096,
           "fallbacks": fallbacks}
    if trips is not None:
        got["fallback_trips"] = trips
    return got


def _trace(device=True):
    """One traced chunk: the window is 0-100 ms."""
    return Trace(config={"config": {"max_source": 8192}}, traffic={},
                 device=[("k", 35 * MS, 90 * MS)] if device else [],
                 host=[("kicp.run_device", 0, 100 * MS)],
                 spans=[("icp_bench.chunk", 0, 100 * MS)],
                 window=(0, 100 * MS), units=50)


@pytest.mark.parametrize("samples,want", [
    # two chunks in the window, one after it (not counted)
    (((40 * MS, _gn(30, 95)), (90 * MS, _gn(10, 25)),
      (150 * MS, _gn(100, 1000))), 3.0),
    (((40 * MS, _gn(0, 0)),), 0.0),          # nothing fell back
])
def test_reads_trips_a_fallback_lane_frame(gn_samples, samples, want):
    gn_samples(*samples)
    assert harness.load_reader(NAME)(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_device", "no_sample", "no_trips"])
def test_reads_nothing_without_the_program_s_trips(gn_samples, case):
    """No device events (a CPU run), no ``gn`` sample, or samples of a
    program that counts no trips (the parent of the counter): None, where
    the fallback share of the same samples still reads."""
    if case != "no_sample":
        gn_samples((40 * MS, _gn(30)))
    tr = _trace(device=case != "no_device")
    assert harness.load_reader(NAME)(tr) is None
    if case == "no_trips":
        assert harness.load_reader("fallback_share.offline")(tr) == 7.5


def test_the_metric_reads_the_exact_offline_cell_s_counter():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert entry == {"name": NAME, "unit": "trips", "better": "lower",
                     "source": "program_counter", "layer": "registration",
                     "moves": "frames_per_s",
                     "workloads": ["ros_exact.offline8"]}
    assert bench["per_layer"][-1]["name"] == NAME  # appended last
