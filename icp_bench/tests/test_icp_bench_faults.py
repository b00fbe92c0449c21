"""A run whose timed path is broken underneath reads ``correct`` false.

Each test drives a whole tiny run on the CPU (the harness's look for a
card skipped) with one fault planted in the program: a step that returns
its state unchanged, half of the batch left out, and an answer altered
where it is produced.  The cells run on one chip, so no exchange between
chips can be left out.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
from conftest import SECONDS, SEED

from icp_bench.core import harness


def _run(tiny_bench, cell):
    bench, tmp = tiny_bench
    return harness.run_cell(bench, cell, SEED, SECONDS, False, "cpu",
                            time.perf_counter(), tmp,
                            log=open(os.devnull, "w"))


@pytest.fixture
def fresh_runners():
    from kinematic_icp_tpu_torch import offline
    offline._make_runner.cache_clear()
    yield
    offline._make_runner.cache_clear()


@pytest.mark.parametrize("cell", ["tiny.live", "tiny.offline"])
def test_the_unbroken_program_is_correct(tiny_bench, cell, fresh_runners):
    r = _run(tiny_bench, cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny.live", "tiny.offline"])
def test_a_step_that_returns_its_state_unchanged(tiny_bench, cell,
                                                 monkeypatch, fresh_runners):
    from kinematic_icp_tpu_torch.models import pipeline
    finish = pipeline.finish_frame

    def unchanged(state, *args, **kwargs):
        return state, finish(state, *args, **kwargs)[1]

    monkeypatch.setattr(pipeline, "finish_frame", unchanged)
    r = _run(tiny_bench, cell)
    assert not r["correct"]
    assert r["checks"]["pose_gap_m"]["value"] > 0.5


def test_half_of_the_batch_left_out(tiny_bench, monkeypatch, fresh_runners):
    """``run_device`` runs the first half of the lanes; the rest pad as
    the runner pads rows past its sequences."""
    from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
    run_device = BatchedOdometryRunner.run_device

    def half(self, sequences):
        return run_device(self, sequences[:max(1, len(sequences) // 2)])

    monkeypatch.setattr(BatchedOdometryRunner, "run_device", half)
    r = _run(tiny_bench, "tiny.offline")
    assert not r["correct"]
    assert r["checks"]["pose_gap_m"]["value"] > 0.5


def test_an_answer_altered_where_it_is_produced_live(tiny_bench,
                                                     monkeypatch):
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    pose_from_ret = LidarOdometryServer._pose_from_ret
    count = {"n": 0}

    def altered(self, row):
        pose = pose_from_ret(self, row)
        count["n"] += 1
        if count["n"] == 7:
            pose = pose.copy()
            pose[0, 3] += 0.5
        return pose

    monkeypatch.setattr(LidarOdometryServer, "_pose_from_ret", altered)
    r = _run(tiny_bench, "tiny.live")
    assert not r["correct"]
    assert r["checks"]["pose_gap_m"]["value"] == pytest.approx(0.5,
                                                               abs=0.05)


def test_an_answer_altered_where_it_is_produced_offline(tiny_bench,
                                                        monkeypatch,
                                                        fresh_runners):
    from kinematic_icp_tpu_torch import offline
    make = offline.make_batched_sequence_runner

    def altered_runner(*args, **kwargs):
        run = make(*args, **kwargs)

        def wrapped(*a):
            state, poses, *rest = run(*a)
            poses = poses.clone()
            poses[-1, -1, 1, 3] += 0.5
            return (state, poses, *rest)

        return wrapped

    from kinematic_icp_tpu_torch.parallel import batched
    monkeypatch.setattr(batched, "make_batched_sequence_runner",
                        altered_runner)
    r = _run(tiny_bench, "tiny.offline")
    assert not r["correct"]
    assert r["checks"]["pose_gap_m"]["value"] == pytest.approx(0.5,
                                                               abs=0.05)


def test_overflow_reported_by_the_window_fails_the_run(tiny_bench,
                                                       monkeypatch,
                                                       fresh_runners):
    """A capacity the traffic overflows is a dropped answer: the tiny
    offline cell at a 64-slot source capacity."""
    from icp_bench.core import driving
    port_config = driving.port_config

    def small(config, device):
        return port_config(config, device).replace(max_source=64)

    monkeypatch.setattr(driving, "port_config", small)
    r = _run(tiny_bench, "tiny.offline")
    assert not r["correct"]
    assert r["checks"]["overflow"]["value"] > 0
    assert np.isfinite(r["checks"]["pose_gap_m"]["value"])
