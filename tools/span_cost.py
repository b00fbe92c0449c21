"""What the program's spans cost while they record, and how far the
profiler's own tracing inflates them, on the card.

    python3 tools/span_cost.py [--seed N] [--turns 2] [--out FILE]

For each cell of ``BENCHMARK.json``: traced windows as the benchmark traces
them (``icp_bench.core.harness.Tracer``, a fresh driver each turn, the
cell's seed), in turns with the spans recording and with
``profiling.span`` doing nothing: the median of the benchmark's own span
(``icp_bench.frame`` a live frame, ``icp_bench.chunk`` an offline chunk),
the device's idle share over the traced window, and the median of each
``kicp.`` span a unit.  Then one untraced window of each cell inside
``profiling.recording()`` (no profiler): the same ``kicp.`` medians from
the module's buffer, so the two can be set side by side.  Prints one JSON
line a window, with the card's name and power limit; the last line sums
them.  The live windows are 7 s (70 frames, 50 traced), the offline ones
two chunks (the second traced).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SECONDS = {"live": 7.0, "offline": 3.0}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _medians(events, units):
    """Median a unit of each ``kicp.`` span's summed ms inside each unit
    (``units``: (start, end) of each traced frame or chunk)."""
    out = {}
    names = {n for n, _, _ in events if n.startswith("kicp.")}
    for name in sorted(names):
        own = [(s, e) for n, s, e in events if n == name]
        out[name] = statistics.median(
            sum(min(e, hi) - max(s, lo) for s, e in own
                if e > lo and s < hi) / 1e6 for lo, hi in units)
    return out


def _window(harness, bench, workload, seed, traced, spans_on,
            device="cuda", bench_dir=None):
    """One window of ``workload``: traced or inside ``recording()``."""
    import torch

    from icp_bench.core.trace import busy_ns
    from kinematic_icp_tpu_torch.utils import profiling
    bench_dir = bench_dir or harness.BENCH
    cell = harness.find_cell(bench, workload, bench_dir)
    kind = cell.traffic["driver"]
    driver = harness.make_driver(cell, seed, SECONDS[kind], device,
                                 bench_dir)
    driver.prepare()
    span = profiling.span
    if not spans_on:
        profiling.span = lambda name: profiling._OFF
    try:
        if traced:
            cuda = device == "cuda"
            tracer = harness.Tracer(cell.traffic["traced"], cuda)
            tracer.warm_up()
            if cuda:
                torch.cuda.synchronize()
            driver.measure(tracer)
            ops, host, spans = tracer.events()
            units = [(s, e) for _, s, e in spans]
            lo, hi = units[0][0], units[-1][1]
            row = {"unit_ms": statistics.median((e - s) / 1e6
                                                for s, e in units),
                   "idle_share": (1 - busy_ns(ops, lo, hi) / (hi - lo)
                                  if ops else None),
                   "kicp_ms": _medians(host, units)}
        else:
            profiling._buffer.clear()
            with profiling.recording():
                driver.measure(None)
            got = defaultdict(list)
            for name, t, v in profiling._buffer:
                if name.startswith("kicp.") and "end_ns" in v:
                    got[name].append((name, t, v["end_ns"]))
            outer = "kicp.register_frame" if kind == "live" \
                else "kicp.run_device"
            units = [(s, e) for _, s, e in got[outer]]
            row = {"unit_ms": statistics.median((e - s) / 1e6
                                                for s, e in units),
                   "kicp_ms": _medians(
                       [x for v in got.values() for x in v], units)}
    finally:
        profiling.span = span
        driver.release()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    from icp_bench.core import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    card = _card()
    rows = []
    for w in bench["workloads"]:
        for turn in range(args.turns):
            for spans_on in (True, False) if turn % 2 == 0 else (False,
                                                                 True):
                t0 = time.perf_counter()
                row = _window(harness, bench, w["name"], args.seed, True,
                              spans_on)
                rows.append({"workload": w["name"], "traced": True,
                             "spans": spans_on, "turn": turn, **row,
                             "s": time.perf_counter() - t0, "card": card})
                print(json.dumps(rows[-1]), flush=True)
        row = _window(harness, bench, w["name"], args.seed, False, True)
        rows.append({"workload": w["name"], "traced": False, "spans": True,
                     **row, "card": card})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    summary = {}
    for w in bench["workloads"]:
        mine = [r for r in rows if r["workload"] == w["name"]]
        summary[w["name"]] = {
            key: statistics.median(r["unit_ms"] for r in mine
                                   if r["traced"] == traced
                                   and r["spans"] == on)
            for key, traced, on in (("traced_spans_on_ms", True, True),
                                    ("traced_spans_off_ms", True, False),
                                    ("recording_ms", False, True))}
    print(json.dumps({"summary": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
