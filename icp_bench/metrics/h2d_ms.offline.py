"""Device time of host-to-device copies a batched frame, in ms, over the
traced chunks (``run_device`` uploads the padded chunk before its
frames run)."""


def read(trace):
    lo, hi = trace.window
    copies = [(s, e) for name, s, e in trace.device
              if "HtoD" in name and e > lo and s < hi]
    if not trace.device or not trace.units:
        return None
    return sum(min(e, hi) - max(s, lo) for s, e in copies) / 1e6 \
        / trace.units
