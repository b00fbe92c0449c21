"""Host time of the serving layer a frame, in ms: each traced frame's
``kicp.register_frame`` span less the ``kicp.launch`` and ``kicp.readback``
spans inside it (what is left: the stationary gate, the pack, the upload's
host side, the pose and overflow decode, the twist), median over the
traced frames.  None where the program records no such span."""

import statistics

from icp_bench.core.trace import clipped


def read(trace):
    frames = [x for x in trace.host if x[0] == "kicp.register_frame"]
    inner = [x for x in trace.host
             if x[0] in ("kicp.launch", "kicp.readback")]
    if not trace.device or not frames:
        return None
    return statistics.median(
        (e - s - sum(b - a for a, b in clipped(inner, s, e))) / 1e6
        for _, s, e in frames)
