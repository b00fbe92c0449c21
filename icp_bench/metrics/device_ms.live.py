"""Device time a frame, in ms: the union of the device's operations inside
the span of each traced ``register_frame`` call (from the upload to the
read-back of the pose), median over the traced frames."""

import statistics

from icp_bench.core.trace import busy_ns


def per_frame(trace):
    return [busy_ns(trace.device, s, e) / 1e6 for _, s, e in trace.spans]


def read(trace):
    if not trace.device or not trace.spans:
        return None
    return statistics.median(per_frame(trace))
