"""Full-27 loop trips a fallback lane-frame over the traced chunks: the
program's ``gn`` counts, summed trips of the lane-frames whose certified
solve failed over their number (0 where none failed).  Each trip after the
first re-associates through the full-27 search.  None where the program
keeps no such counts (a program before ``fallback_trips``)."""


def read(trace):
    try:
        from kinematic_icp_tpu_torch.utils.profiling import samples
    except ImportError:
        return None
    got = samples("gn", *trace.window) if trace.device else []
    got = [v for _, v in got if "fallback_trips" in v]
    if not got:
        return None
    fallbacks = sum(v["fallbacks"] for v in got)
    if not fallbacks:
        return 0.0
    return sum(v["fallback_trips"] for v in got) / fallbacks
