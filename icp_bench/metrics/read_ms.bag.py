"""Host time a frame spends pulling its scan's message from the bag, in
ms: the program's ``kicp.bag_read`` spans (MCAP records, chunk
decompression, /tf and /tf_static replay into the transform buffer)
inside the traced pass, over the pass's frames.  None where the program
records no such span."""

from icp_bench.core.spans import ms_per_unit


def read(trace):
    return ms_per_unit(trace, "kicp.bag_read")
