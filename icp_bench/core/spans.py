"""Readings of the program's own spans in a traced window."""

from __future__ import annotations

from .trace import clipped


def ms_per_unit(trace, name: str) -> float | None:
    """Host ms inside the program's ``name`` spans in the traced window,
    over the window's units (frames); None where the program records no
    such span, or the trace holds no device activity (a CPU run)."""
    spans = [x for x in trace.host if x[0] == name]
    if not trace.device or not spans or not trace.units:
        return None
    lo, hi = trace.window
    return sum(e - s for s, e in clipped(spans, lo, hi)) / 1e6 / trace.units
