"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison with the reference and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* ``icp_bench/configs/<config>.json``: the deployment (the program's
  ``Config`` fields, the reference's association, the sensor and world);
* ``icp_bench/traffic/<traffic>.json``: the mix's parameters and the
  name of the driver that runs it;
* ``icp_bench/drivers/<driver>.py``: the loop that drives the program's
  entry, a ``Driver`` class (``core/driving.py`` says what it offers);
* ``icp_bench/metrics/<metric>.py``: a per-layer metric's reader, a
  ``read(trace)`` that returns a number or None;
* ``icp_bench/cells/<workload>.json``: the limits the comparison holds
  the cell's numbers to, with the readings each was set from.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from . import trace as trace_mod

BENCH = Path(__file__).resolve().parent.parent
#: top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "kinematic_icp_tpu")


class CellError(Exception):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(benchmark: dict, workload: str, bench_dir: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``benchmark`` with its files."""
    entries = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in entries:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[workload]

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return Cell(
        name=workload, entry=entry,
        config=load_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench_dir / "cells" / f"{workload}.json"),
        end_to_end=[m for m in benchmark["end_to_end"] if applies(m)],
        per_layer=[m for m in benchmark["per_layer"] if applies(m)])


def _load(kind: str, name: str, bench_dir: Path):
    """The module ``<kind>/<name>.py`` of the benchmark."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise CellError(f"no {kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"icp_bench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str, bench_dir: Path = BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name, bench_dir).read


def load_driver(name: str, bench_dir: Path = BENCH):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return _load("drivers", name, bench_dir).Driver


def make_driver(cell: Cell, seed: int, seconds: float, device,
                bench_dir: Path = BENCH, traffic: dict | None = None):
    """The driver of ``cell``'s mix (or of ``traffic``), built."""
    traffic = cell.traffic if traffic is None else traffic
    return load_driver(traffic["driver"], bench_dir)(
        cell.config, traffic, seed, seconds, device)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``kinematic_icp_tpu_torch`` is not ``kinematic_icp_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _translation_gaps(prog, ref):
    return np.linalg.norm(prog[:, :3, 3] - ref[:, :3, 3], axis=1)


def compare(answers, reference_poses, limits: dict) -> tuple[bool, dict]:
    """Hold what the window returned to the reference.

    ``answers``: [(drive, program poses (F, 4, 4), overflow total)];
    ``reference_poses``: drive id -> the reference's (F_max, 4, 4) poses.
    Returns (correct, {number: {"value", "limit"}}): the largest
    translation gap between a program pose and the reference's pose of
    the same frame, and the capacity overflow total (the reference drops
    nothing)."""
    gap = 0.0
    overflow = 0
    for drive, poses, ovf in answers:
        overflow += ovf
        if len(poses) == 0:
            continue
        ref = reference_poses[id(drive)][:len(poses)]
        g = _translation_gaps(poses, ref)
        gap = max(gap, float(np.max(g)) if np.all(np.isfinite(g))
                  else math.inf)
    numbers = {"pose_gap_m": {"value": gap,
                              "limit": limits["pose_gap_m"]["limit"]},
               "overflow": {"value": overflow,
                            "limit": limits["overflow"]["limit"]}}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    return correct, numbers


def run_reference(answers, config: dict, device, precision="float64"):
    """The reference's poses of every drive in ``answers`` over as many
    frames as any answer of that drive holds."""
    import torch

    from ..reference import kicp
    need = {}
    for drive, poses, _ in answers:
        need[id(drive)] = (drive, max(len(poses), need.get(id(drive),
                                                         (None, 0))[1]))
    cfg = {**config["config"], **config["reference"]}
    out = {}
    with torch.no_grad():
        for key, (drive, frames) in need.items():
            out[key] = kicp.run_drive(drive, cfg, device, precision, frames)
    return out


class Tracer:
    """``torch.profiler`` over the units ``[first, last)`` of a window (a
    live cell's frames, an offline cell's chunks): started before the
    first, stopped after the last, which the device has finished; each
    unit in a span of its own."""

    def __init__(self, units, cuda: bool):
        self.first, self.last = int(units[0]), int(units[1])
        self.cuda = cuda
        self.prof = None

    def warm_up(self):
        """Start and stop the profiler once, in set-up: its first start
        initialises the device's tracing, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            pass

    def span(self, name, i):
        import contextlib

        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.first <= i < self.last:
            return contextlib.nullcontext()
        if i == self.first:
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        stack = contextlib.ExitStack()
        if i == self.last - 1:
            stack.callback(self._stop)
        stack.enter_context(record_function(name))
        return stack

    def _stop(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def events(self):
        """(device, host, spans) as (name, start_ns, end_ns) lists."""
        from torch.autograd import DeviceType
        device, host, spans = [], [], []
        if self.prof is None:
            return device, host, spans
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            item = (e.name(), s, s + e.duration_ns())
            if e.name().startswith("icp_bench."):
                # the spans, and their shadows on the device's timeline
                if e.device_type() != DeviceType.CUDA:
                    spans.append(item)
            elif e.device_type() == DeviceType.CUDA:
                device.append(item)
            else:
                host.append(item)
        self.prof = None
        return device, host, spans


def run_cell(benchmark: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, bench_dir: Path = BENCH,
             log=sys.stderr) -> dict:
    """One run; returns the result line's object."""
    import torch

    cell = find_cell(benchmark, workload, bench_dir)
    driver = make_driver(cell, seed, seconds, device, bench_dir)
    cuda = torch.device(device).type == "cuda"
    driver.prepare()
    tracer = Tracer(cell.traffic["traced"], cuda) if traced else None
    if tracer is not None:
        tracer.warm_up()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives to the end of the run: out of the collector's
    # way, so that no collection of it lands inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    start, end = driver.measure(tracer)
    metrics = {k: {"value": v, "unit": u}
               for k, (v, u) in driver.metrics(start, end).items()}
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    out_device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name() if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if traced:
        t_trace = time.perf_counter()
        metrics, breakdown, busy_s, window_s = _read_trace(
            cell, tracer, driver.units_per_span, bench_dir)
        out_device["busy_s"], out_device["window_s"] = busy_s, window_s
        trace_s = time.perf_counter() - t_trace
    else:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        want = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in want}

    answers = driver.answers()
    attempted = driver.frames()
    notes = driver.notes()
    driver.release()
    del driver
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = run_reference(answers, cell.config, device)
    correct, numbers = compare(answers, ref, cell.limits)
    notes["reference_s"] = time.perf_counter() - t_ref
    notes["setup_s"] = setup_s
    if traced:
        notes["trace_s"] = trace_s
    print(json.dumps({"notes": notes}), file=log)

    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = numbers
    return result


def _read_trace(cell: Cell, tracer: Tracer, units_per_span: int,
                bench_dir: Path):
    """(per-layer metrics, breakdown, busy_s, window_s) of the traced
    spans, each of ``units_per_span`` frames: the window runs from the
    first span's start to the last span's end."""
    device, host, spans = tracer.events()
    window = ((min(s for _, s, _ in spans), max(e for _, _, e in spans))
              if spans else (0, 0))
    tr = trace_mod.Trace(config=cell.config, traffic=cell.traffic,
                         device=device, host=host, spans=spans,
                         window=window, units=len(spans) * units_per_span)
    metrics = {}
    for m in cell.per_layer:
        value = load_reader(m["name"], bench_dir)(tr)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lo, hi = window
    return (metrics, trace_mod.breakdown(tr),
            trace_mod.busy_ns(device, lo, hi) / 1e9, (hi - lo) / 1e9)
