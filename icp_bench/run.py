"""Run one cell of the benchmark once, on the card of this machine.

    python3 icp_bench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Sets up the cell named in ``BENCHMARK.json``
(its inputs from ``--seed``, the program built and warmed up), measures
for ``--seconds``, holds what the window returned to the plain reference,
and prints one JSON line as the last line of standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics from a
profiled sub-window with ``--trace 1``.  The numbers compared come last
there, under ``checks``, and again as the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card, or when a module
of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent
#: build and kernel caches of the program, at fixed paths in the checkout
CACHE = HERE / ".cache"


def _cache_env():
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_env()
    sys.path.insert(0, str(HERE.parent))
    from icp_bench.core import harness

    benchmark = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(benchmark, args.workload)
    import torch
    # one process, one host thread for torch's own CPU work
    torch.set_num_threads(1)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"icp_bench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(benchmark, args.workload, args.seed,
                              args.seconds, bool(args.trace), "cuda",
                              T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"icp_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
