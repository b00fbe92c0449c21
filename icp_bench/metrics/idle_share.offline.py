"""Share of the traced chunk in which the device ran nothing, in %: one
minus the union of its kernels, copies and fills over the span of the
chunk's ``run_device`` call (``pad_batch``, the upload, the replays and the
read-back)."""

from icp_bench.core.trace import busy_ns


def read(trace):
    lo, hi = trace.window
    if not trace.device or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_ns(trace.device, lo, hi) / (hi - lo))
