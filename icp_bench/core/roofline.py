"""The chip's peak and the GN kernel's least time.

``gn_bytes`` is a frozen copy of the byte count of ``chip_smoke.gn_bound``
at commit dc36a2491db637ba74eeae484c593953a0d99c15: every input read once
and every output written once (the candidate words, their offset ids and
voxel bases, the source points and mask, the guess and tau; the pose, the
counts, the point-space error and the certificate's flag).  The program
does not report how many selection passes a frame took, so the bound is
the bytes term alone, a lower bound on the least time; the operations
term comes back once the passes can be read.  The count takes every one
of the ``max_source`` queries as live: the kernel reads no source, base or
candidate word of a masked query, so where a frame has fewer sources the
bound, and the share, read high.
"""

from __future__ import annotations

#: NVIDIA's data sheet for the H100 SXM (700 W): HBM3 bytes/s
H100_HBM_BYTES_PER_S = 3.35e12


def gn_bytes(v: int, k: int, n: int) -> int:
    """Bytes of one frame's solve: inputs read once, outputs written
    once."""
    return (v * k * n * 4 + v * n * 4 + 3 * n * 4   # words, rel, base
            + 3 * n * 4 + n                         # source, mask
            + 64 + 4                                # guess, tau
            + 64 + 4 + 4 + 4 + 1)                   # outputs


def gn_bound_bytes(v: int, k: int, n: int, frames: int) -> float:
    """Seconds to move the bytes of ``frames`` solves at the HBM peak."""
    return frames * gn_bytes(v, k, n) / H100_HBM_BYTES_PER_S


#: the GN kernel's name in a device trace
GN_KERNEL = "gn_solve_kernel"


def gn_share(trace) -> float | None:
    """The GN kernel's share of its roofline over a trace's window, in %:
    the bytes bound of its solves over the device time of its launches.
    A launch solves ``lanes`` frames (1 without lanes) at the
    configuration's candidate voxels (27 under the exact mode: the
    ``check_crossing`` instance), ``max_points_per_voxel`` points a voxel
    and ``max_source`` queries.  None without a launch in the window."""
    lo, hi = trace.window
    launches = [e - s for name, s, e in trace.device
                if GN_KERNEL in name and s >= lo and e <= hi]
    if not launches:
        return None
    c = trace.config["config"]
    v = 27 if c["exact_gn_reassociation"] else c["neighbor_candidates"]
    frames = int(trace.traffic.get("lanes", 1))
    bound = gn_bound_bytes(v, c["max_points_per_voxel"], c["max_source"],
                           frames)
    return 100.0 * bound * len(launches) / (sum(launches) / 1e9)
