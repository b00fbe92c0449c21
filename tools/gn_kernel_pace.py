"""Where a solve of the GN kernel spends its time on the card.

Usage (on a machine with a CUDA card):

    python3 tools/gn_kernel_pace.py [--out FILE]

For N in (1024, 8192) and V in (1, 10, 27), K = 20, on the realistic scan
of ``chip_smoke.py`` (its ``gn_problem``), times the kernel's device work
(``chip_smoke.median_ms``) with its whole loop and with no iteration (the
launch and one selection pass).  Prints one JSON line per shape:
iterations, CTAs, candidate rows per warp, ms, one_pass_ms and per_pass_ms
= (ms - one_pass_ms) / iterations.  Then one line per N with the
least-squares line per_pass_ms = a + b * rows_per_warp: the slope b is
the scan of the candidate rows, the intercept a what every pass pays
whatever its rows (the grid barrier, the G-way reduction of the partial
sums, the serial 2x2 solve and the per-query terms); launch_ms =
one_pass_ms - per_pass_ms is the launch and the first pass's cold reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 20
WARPS = 8  # kWarps of csrc/gn_solve.cu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from chip_smoke import gn_problem, median_ms, nvidia_smi_line
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils import synthetic

    if not torch.cuda.is_available():
        print("gn_kernel_pace: no CUDA card", file=sys.stderr)
        return 1
    card = nvidia_smi_line()
    seq = synthetic.make_sequence(1, lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    lines = []
    for n in (1024, 8192):
        rows = []
        for v in (1, 10, 27):
            a, kw, _, _ = gn_problem(torch, np, seq, v, n, False)
            out = gn.gn_solve(*a, backend="cuda", **kw)
            iterations = int(out[1])
            ms = median_ms(lambda: gn.gn_solve(*a, backend="cuda", **kw))
            one = median_ms(lambda: gn.gn_solve(
                *a, backend="cuda", **{**kw, "max_num_iterations": 0}))
            per_pass = (ms - one) / max(iterations, 1)
            row = {"N": n, "V": v, "K": K, "ctas": gn.LAST_CTAS,
                   "rows_per_warp": -(-v * K // WARPS),
                   "iterations": iterations, "ms": ms, "one_pass_ms": one,
                   "per_pass_ms": per_pass, "launch_ms": one - per_pass,
                   "nvidia_smi": card}
            rows.append(row)
            lines.append(row)
        x = np.array([r["rows_per_warp"] for r in rows], float)
        y = np.array([r["per_pass_ms"] for r in rows], float)
        slope, intercept = np.polyfit(x, y, 1)
        lines.append({"N": n, "fit": "per_pass_ms = a + b * rows_per_warp",
                      "a_ms": float(intercept), "b_ms_per_row": float(slope),
                      "nvidia_smi": card})
    text = "\n".join(json.dumps(ln) for ln in lines)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
