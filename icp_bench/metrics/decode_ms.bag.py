"""Host time a frame spends decoding its scan, in ms: the program's
``kicp.decode`` spans (the CDR decode, the points and the per-point
times extracted and normalised) inside the traced pass, over the pass's
frames.  None where the program records no such span."""

from icp_bench.core.spans import ms_per_unit


def read(trace):
    return ms_per_unit(trace, "kicp.decode")
