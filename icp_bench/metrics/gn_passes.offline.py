"""GN kernel passes an active lane-frame over the traced chunks (the
full-27 fallback loop's trips not counted): the program's ``gn`` counts,
summed passes over summed lane-frames.  None where the program keeps no
such counts."""


def gn_totals(trace):
    """Sums of the program's ``gn`` samples inside the traced window
    (``kinematic_icp_tpu_torch.utils.profiling.samples``), or None."""
    try:
        from kinematic_icp_tpu_torch.utils.profiling import samples
    except ImportError:
        return None
    got = samples("gn", *trace.window) if trace.device else []
    if not got:
        return None
    return {k: sum(v[k] for _, v in got)
            for k in ("frames", "passes", "sources", "fallbacks")}


def read(trace):
    totals = gn_totals(trace)
    if totals is None or not totals["frames"]:
        return None
    return totals["passes"] / totals["frames"]
