"""Host time a frame, in ms: each traced ``register_frame`` call's span
less the device time inside it (the pack, the pageable upload's host side,
the launch of the replay, the wait for the read-back and the host's pose
and overflow book-keeping), median over the traced frames."""

import statistics

from icp_bench.core.trace import busy_ns


def read(trace):
    if not trace.device or not trace.spans:
        return None
    return statistics.median((e - s - busy_ns(trace.device, s, e)) / 1e6
                             for _, s, e in trace.spans)
