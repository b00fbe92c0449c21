"""The readers of the program's own spans (``kicp.*`` host events) and
counts (``gn`` samples of ``kinematic_icp_tpu_torch.utils.profiling``):
their values on a synthetic trace, None without device events, and on the
card a traced run of each tiny cell that reports every one of them."""

from __future__ import annotations

import json
import os
import statistics
import time

import pytest
import torch
from conftest import ROOT, SECONDS, SEED

from icp_bench.core import harness
from icp_bench.core.trace import Trace
from kinematic_icp_tpu_torch.utils import profiling

LIVE = ("launch_ms.live", "serving_ms.live", "gn_passes.live")
OFFLINE = ("pad_batch_ms.offline", "launch_ms.offline",
           "fallback_share.offline", "gn_passes.offline",
           "gn_live_queries.offline")
MS = 1_000_000  # ns


@pytest.fixture
def gn_samples():
    profiling._buffer.clear()

    def seed(*samples):
        for t, values in samples:
            profiling._buffer.append(("gn", t, values))

    yield seed
    profiling._buffer.clear()


def _gn(frames, passes, sources, fallbacks):
    return {"frames": frames, "passes": passes, "sources": sources,
            "fallbacks": fallbacks}


def _live_trace():
    """Two frames: 0.5 and 0.3 ms launching, serving 3.8 − 0.5 − 2.2 and
    3.0 − 0.3 − 2.0 ms."""
    host = [("kicp.register_frame", 1.1 * MS, 4.9 * MS),
            ("kicp.pack", 1.1 * MS, 1.6 * MS),
            ("kicp.upload", 1.6 * MS, 1.8 * MS),
            ("kicp.launch", 1.8 * MS, 2.3 * MS),
            ("cudaGraphLaunch", 1.9 * MS, 2.2 * MS),
            ("kicp.readback", 2.3 * MS, 4.5 * MS),
            ("kicp.register_frame", 10.1 * MS, 13.1 * MS),
            ("kicp.launch", 10.5 * MS, 10.8 * MS),
            ("kicp.readback", 10.8 * MS, 12.8 * MS)]
    return Trace(config={"config": {"max_source": 8192}}, traffic={},
                 device=[("k", 2.0 * MS, 4.4 * MS),
                         ("k", 10.9 * MS, 12.7 * MS)],
                 host=host,
                 spans=[("icp_bench.frame", 1 * MS, 5 * MS),
                        ("icp_bench.frame", 10 * MS, 14 * MS)],
                 window=(1 * MS, 14 * MS), units=2)


def _offline_trace():
    """One chunk of 50 batched frames: 30 ms packing, 2.5 ms launching
    (a launch after the window is not counted)."""
    host = [("kicp.run_device", 0, 100 * MS),
            ("kicp.pad_batch", 1 * MS, 31 * MS),
            ("kicp.launch", 40 * MS, 41 * MS),
            ("kicp.launch", 50 * MS, 51.5 * MS),
            ("kicp.launch", 150 * MS, 151 * MS)]
    return Trace(config={"config": {"max_source": 8192}}, traffic={},
                 device=[("k", 35 * MS, 90 * MS)], host=host,
                 spans=[("icp_bench.chunk", 0, 100 * MS)],
                 window=(0, 100 * MS), units=50)


def test_live_readers_read_the_frames_spans_and_counts(gn_samples):
    gn_samples((4.6 * MS, _gn(1, 3, 5000, 0)), (12.9 * MS, _gn(1, 5, 6000, 0)),
               (20 * MS, _gn(1, 100, 1, 0)))
    tr = _live_trace()
    got = {m: harness.load_reader(m)(tr) for m in LIVE}
    assert got == pytest.approx({"launch_ms.live": 0.4,
                                 "serving_ms.live": 0.9,
                                 "gn_passes.live": 4.0})


def test_offline_readers_read_the_chunks_spans_and_counts(gn_samples):
    gn_samples((99 * MS, _gn(400, 1200, 400 * 4096, 100)),
               (120 * MS, _gn(400, 4000, 1, 400)))
    tr = _offline_trace()
    got = {m: harness.load_reader(m)(tr) for m in OFFLINE}
    assert got == pytest.approx({"pad_batch_ms.offline": 0.6,
                                 "launch_ms.offline": 0.05,
                                 "fallback_share.offline": 25.0,
                                 "gn_passes.offline": 3.0,
                                 "gn_live_queries.offline": 50.0})


@pytest.mark.parametrize("metric", LIVE + OFFLINE)
def test_a_reader_gives_none_without_device_events(metric, gn_samples):
    gn_samples((4.6 * MS, _gn(1, 3, 5000, 0)), (99 * MS, _gn(8, 9, 10, 1)))
    tr = _live_trace() if metric in LIVE else _offline_trace()
    tr.device = []
    assert harness.load_reader(metric)(tr) is None


@pytest.mark.parametrize("metric", LIVE + OFFLINE)
def test_a_reader_gives_none_where_the_program_records_nothing(metric,
                                                               gn_samples):
    """The parent of these spans and counts: device events, no ``kicp.``
    span and no ``gn`` sample."""
    tr = _live_trace() if metric in LIVE else _offline_trace()
    tr.host = [x for x in tr.host if not x[0].startswith("kicp.")]
    assert harness.load_reader(metric)(tr) is None


def test_every_program_metric_is_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for names, cell in ((LIVE, "ros_default.live10hz"),
                        (OFFLINE, "ros_exact.offline8")):
        for name in names:
            assert entries[name]["workloads"] == [cell]
            assert entries[name]["source"] in ("program_span",
                                               "program_counter")


@pytest.mark.cuda
def test_traced_tiny_cells_on_the_card_report_the_program_metrics(
        tiny_bench, monkeypatch):
    """On the card: a traced run of each tiny cell reports every new
    metric; no event the tracer files under the device is a ``kicp.``
    span; the offline idle share with the spans on agrees, within the
    traced runs' spread, with runs whose spans do nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the traced runs time its work")
    bench, tmp = tiny_bench
    device_names = set()
    events = harness.Tracer.events

    def spy(self):
        out = events(self)
        device_names.update(name for name, _, _ in out[0])
        return out

    monkeypatch.setattr(harness.Tracer, "events", spy)

    def run(cell):
        return harness.run_cell(bench, cell, SEED, SECONDS, True, "cuda",
                                time.perf_counter(), tmp,
                                log=open(os.devnull, "w"))

    r = run("tiny.live")
    assert r["correct"], r["checks"]
    assert set(LIVE) <= set(r["metrics"])
    idle = {True: [], False: []}
    for on in (True, False) * 3:
        with monkeypatch.context() as m:
            if not on:
                m.setattr(profiling, "span", lambda name: profiling._OFF)
            r = run("tiny.offline")
        assert r["correct"], r["checks"]
        if on:
            assert set(OFFLINE) <= set(r["metrics"])
        idle[on].append(r["metrics"]["idle_share.offline"]["value"])
    assert device_names
    assert not [n for n in device_names if n.startswith("kicp.")]
    spread = max(max(v) - min(v) for v in idle.values())
    assert abs(statistics.median(idle[True])
               - statistics.median(idle[False])) <= spread, idle
