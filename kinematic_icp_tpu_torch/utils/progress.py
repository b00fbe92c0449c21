"""Terminal progress bar (stand-in for the vendored indicators.hpp).

The reference offline node renders a block progress bar with elapsed /
remaining time (ros/src/kinematic_icp_ros/nodes/offline_node.cpp:100-111);
this is the dependency-free equivalent.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, total: int, desc: str = "", width: int = 40,
                 stream=None, min_interval: float = 0.1):
        self.total = max(total, 1)
        self.desc = desc
        self.width = width
        self.n = 0
        self.start = time.time()
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self._last_render = 0.0

    def update(self, k: int = 1):
        self.n += k
        now = time.time()
        if now - self._last_render >= self.min_interval or self.n >= self.total:
            self._last_render = now
            self._render()

    def _render(self):
        frac = min(self.n / self.total, 1.0)
        filled = int(self.width * frac)
        bar = "█" * filled + "░" * (self.width - filled)
        elapsed = time.time() - self.start
        rate = self.n / elapsed if elapsed > 0 else 0.0
        remaining = (self.total - self.n) / rate if rate > 0 else 0.0
        self.stream.write(
            f"\r{self.desc} [{bar}] {self.n}/{self.total} "
            f"{rate:5.1f}/s elapsed {elapsed:5.1f}s eta {remaining:5.1f}s")
        self.stream.flush()

    def close(self):
        self._render()
        self.stream.write("\n")
        self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
