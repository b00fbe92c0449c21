"""The GN kernel of two checkouts on the same inputs: bit-equal, and how fast.

Usage (on a machine with a CUDA card, from this checkout's root):

    python3 tools/gn_kernel_parity.py OTHER_ROOT [--out FILE]

``OTHER_ROOT`` is another checkout of the repository (for instance the
parent commit, unpacked with ``git archive`` into ``chip_checkout/``).  For
each root, in the order other, this, this, other, a subprocess imports that
root's ``kinematic_icp_tpu_torch``, builds its GN kernel, solves the three
single-frame problems of ``chip_smoke.py``'s ``gn_solve`` phase (V=10 K=20
N=1024; V=10 N=8192; V=27 N=1024 with the crossing certificate) and times
each with ``chip_smoke.median_ms``.  Prints one JSON line: whether every
output (pose, iterations, correspondences, error, crossed) of the two
roots is bit-equal at each shape, and each run's kernel ms, beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (V, N, check_crossing) of chip_smoke.py's single-frame kernel phase
SHAPES = ((10, 1024, False), (10, 8192, False), (27, 1024, True))


def _dump(root, out):
    """Solve SHAPES with ``root``'s package; save outputs and ms to
    ``out`` (an .npz)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    # this checkout's chip_smoke (inputs and timing) over root's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.utils import synthetic

    if not os.path.abspath(gn.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {gn.__file__}, not {root}'s package")
    seq = synthetic.make_sequence(1, lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    arrays = {}
    for v, n, check in SHAPES:
        args, kw, _, _ = cs.gn_problem(torch, np, seq, v, n, check)
        outs = gn.gn_solve(*args, backend="cuda", **kw)
        torch.cuda.synchronize()
        for i, t in enumerate(outs):
            arrays[f"{v}_{n}_{i}"] = (t.reshape(-1).view(torch.uint8)
                                      .cpu().numpy())
        arrays[f"{v}_{n}_ms"] = np.float64(cs.median_ms(
            lambda: gn.gn_solve(*args, backend="cuda", **kw)))
    np.savez(out, **arrays)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--dump", nargs=2, metavar=("ROOT", "NPZ"),
                    help=argparse.SUPPRESS)  # the subprocess's mode
    args = ap.parse_args(argv)
    if args.dump:
        _dump(*args.dump)
        return 0

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import nvidia_smi_line

    if not torch.cuda.is_available():
        print("gn_kernel_parity: no CUDA card", file=sys.stderr)
        return 1
    other = os.path.abspath(args.other_root)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, root in enumerate((other, HERE, HERE, other)):
            out = os.path.join(tmp, f"{k}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            other, "--dump", root, out], check=True,
                           cwd=HERE, timeout=900)
            with np.load(out) as z:
                runs.append({key: z[key] for key in z.files})
    row = {"nvidia_smi": nvidia_smi_line(), "other_root": args.other_root,
           "shapes": []}
    for v, n, check in SHAPES:
        keys = [f"{v}_{n}_{i}" for i in range(5)]
        row["shapes"].append({
            "V": v, "N": n, "check_crossing": check,
            "bit_equal": all(np.array_equal(runs[0][key], runs[1][key])
                             for key in keys),
            "other_ms": [float(runs[0][f"{v}_{n}_ms"]),
                         float(runs[3][f"{v}_{n}_ms"])],
            "this_ms": [float(runs[1][f"{v}_{n}_ms"]),
                        float(runs[2][f"{v}_{n}_ms"])]})
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0 if all(s["bit_equal"] for s in row["shapes"]) else 2


if __name__ == "__main__":
    sys.exit(main())
