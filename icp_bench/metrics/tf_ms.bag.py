"""Host time a frame spends in transform lookups, in ms: the program's
``kicp.tf_lookup`` spans (the first frame's pose seed and extrinsic, and
each frame's wheel-odometry delta between scan end stamps) inside the
traced pass, over the pass's frames.  None where the program records no
such span."""

from icp_bench.core.spans import ms_per_unit


def read(trace):
    return ms_per_unit(trace, "kicp.tf_lookup")
