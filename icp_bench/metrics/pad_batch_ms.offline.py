"""Host time in ``pad_batch`` a batched frame, in ms: the program's
``kicp.pad_batch`` spans (the numpy packing of a chunk) over the traced
chunks, over their batched frames.  None where the program records no
such span."""

from icp_bench.core.trace import clipped


def read(trace):
    spans = [x for x in trace.host if x[0] == "kicp.pad_batch"]
    if not trace.device or not trace.units or not spans:
        return None
    return sum(e - s for s, e in clipped(spans, *trace.window)) / 1e6 \
        / trace.units
