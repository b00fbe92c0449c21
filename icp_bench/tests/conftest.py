"""Tiny cells for the benchmark's CPU tests.

``tiny_bench`` copies the benchmark's data files into a temporary
directory and adds, as new files and entries only, two cells at a size the
CPU runs in seconds: ``tiny.live`` (the live driver over ``ros_default``
cut to a 256-column, 12-ring sensor and 4,096 points) and
``tiny.offline`` (the offline driver over ``ros_exact``, 2 lanes of
8-frame recordings).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {"max_points": 4096, "max_downsampled": 2048,
               "max_source": 1024, "map_capacity": 1 << 14}
TINY_SENSOR = {"columns": 256, "rings": 12}
TINY_TRAFFIC = {
    "live10hz": {"warmup_frames": 3, "rate_hz": 20.0, "traced": [1, 4]},
    "offline8": {"lanes": 2, "recording_frames": 8, "chunk_frames": 4,
                 "traced": [0, 1]},
}
#: seconds of a tiny run: the live cell's 20 Hz gives 12 frames
SECONDS = 0.6
#: the benchmark's folders of files found by name
BENCH_DIRS = ("configs", "traffic", "drivers", "metrics", "cells")
SEED = 2**31 + 11


def _dump(obj, path: Path):
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_bench(tmp: Path) -> dict:
    """The benchmark's files under ``tmp`` plus the two tiny cells; returns
    the BENCHMARK dict with their entries added."""
    for d in BENCH_DIRS:
        shutil.copytree(BENCH / d, tmp / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("ros_default", "ros_exact"):
        c = json.loads((tmp / "configs" / f"{name}.json").read_text())
        c["name"] = f"{name}_tiny"
        c["config"].update(TINY_CONFIG)
        c["sensor"].update(TINY_SENSOR)
        _dump(c, tmp / "configs" / f"{name}_tiny.json")
    for mix, params in TINY_TRAFFIC.items():
        t = json.loads((tmp / "traffic" / f"{mix}.json").read_text())
        t.update(params)
        _dump(t, tmp / "traffic" / f"{mix}_tiny.json")
    for cell, config, mix, like in (
            ("tiny.live", "ros_default_tiny", "live10hz_tiny",
             "ros_default.live10hz"),
            ("tiny.offline", "ros_exact_tiny", "offline8_tiny",
             "ros_exact.offline8")):
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test's size"})
        shutil.copy(tmp / "cells" / f"{like}.json",
                    tmp / "cells" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    import torch
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("icp_bench")
    return make_tiny_bench(tmp), tmp
