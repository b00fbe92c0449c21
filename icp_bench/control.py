"""Readings of the control of the comparison that decides ``correct``,
for setting its limits.

    python3 icp_bench/control.py --workload <name> --seeds 1 2 3
        [--seconds S] [--out FILE]

The control is the reference, computed in TF32 (``reference.kicp``), put
in the program's place over the cell's inputs: every frame the cell's
window could answer.  Each seed prints one JSON line with the numbers
compared and the limits of ``cells/<workload>.json``; the program's own
readings are those of ``run.py``'s runs.  Not part of a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def readings(benchmark, workload, seed, seconds, device, bench_dir=None):
    """(correct, numbers) of the control on one seed."""
    from icp_bench.core import harness
    bench_dir = bench_dir or harness.BENCH
    cell = harness.find_cell(benchmark, workload, bench_dir)
    driver = harness.make_driver(cell, seed, seconds, device, bench_dir)
    # the inputs alone: the control is computed in the program's place
    driver.prepare_inputs()
    frames = driver.input_frames()
    control = harness.run_reference([(d, [None] * n, 0) for d, n in frames],
                                    cell.config, device, "tf32")
    answers = [(d, control[id(d)][:n], 0) for d, n in frames]
    ref = harness.run_reference(answers, cell.config, device)
    return harness.compare(answers, ref, cell.limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    from icp_bench import run
    run._cache_env()
    from icp_bench.core import harness
    benchmark = harness.load_json(Path.cwd() / "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        correct, numbers = readings(benchmark, args.workload, seed,
                                    args.seconds, args.device)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": correct,
                           "numbers": numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
