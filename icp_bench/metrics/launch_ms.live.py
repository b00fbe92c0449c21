"""Host time a frame spends launching its replay, in ms: the program's
``kicp.launch`` spans (``StaticCall``'s graph replay and its counters)
inside each traced ``register_frame`` call, median over the traced
frames.  None where the program records no such span."""

import statistics

from icp_bench.core.trace import clipped


def read(trace):
    launches = [x for x in trace.host if x[0] == "kicp.launch"]
    if not trace.device or not trace.spans or not launches:
        return None
    return statistics.median(
        sum(e - s for s, e in clipped(launches, lo, hi)) / 1e6
        for _, lo, hi in trace.spans)
