"""Trajectory evaluation CLI: ATE / RPE between two TUM files.

The reference emits TUM trajectories and leaves evaluation to external
tools (offline_node.cpp:76-97 + README's workflow); this makes the
framework self-contained (numpy only; the JAX package's numbers on the
same files):

    python -m kinematic_icp_tpu_torch.evaluate est_tum.txt ref_tum.txt
    python -m kinematic_icp_tpu_torch.evaluate est.txt ref.txt --no-align --json

Stamps are matched by nearest neighbor within ``--max-stamp-diff`` (the two
files need not be frame-aligned); prints ATE RMSE, RPE translation /
rotation, and the matched pose count.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .utils.evaluation import ate_rmse, rpe
from .utils.io.tum import read_tum


def associate(stamps_a, stamps_b, max_diff: float):
    """One-to-one nearest-stamp matching; returns (idx_a, idx_b) arrays.

    Each b-index is consumed at most once (smallest stamp distance wins,
    TUM-style), so an oversampled estimate cannot match several poses to
    one reference pose — that would create zero-motion reference pairs and
    deflate RPE.
    """
    order = np.argsort(stamps_b)
    sb = np.asarray(stamps_b)[order]
    pairs = []
    for i, t in enumerate(stamps_a):
        # every reference stamp within max_diff is a candidate (not just
        # the nearest two — those may be consumed by other estimates)
        lo = int(np.searchsorted(sb, t - max_diff, side="left"))
        hi = int(np.searchsorted(sb, t + max_diff, side="right"))
        for k in range(lo, hi):
            pairs.append((abs(sb[k] - t), i, int(order[k])))
    pairs.sort()
    ia, ib, used_a, used_b = [], [], set(), set()
    for _, i, b in pairs:
        if i in used_a or b in used_b:
            continue
        used_a.add(i)
        used_b.add(b)
        ia.append(i)
        ib.append(b)
    keep = np.argsort(ia)
    return (np.asarray(ia, int)[keep], np.asarray(ib, int)[keep])


def evaluate_files(est_path, ref_path, align=True, max_stamp_diff=0.02,
                   rpe_delta=1):
    est_stamps, est_poses = read_tum(est_path)
    ref_stamps, ref_poses = read_tum(ref_path)
    ia, ib = associate(est_stamps, ref_stamps, max_stamp_diff)
    if len(ia) < 2:
        raise ValueError(
            f"only {len(ia)} stamp matches between {est_path} and "
            f"{ref_path} (max_stamp_diff={max_stamp_diff})")
    est = [est_poses[i] for i in ia]
    ref = [ref_poses[i] for i in ib]
    trans_rpe, rot_rpe = rpe(ref, est, delta=rpe_delta)
    return {
        "matched_poses": int(len(ia)),
        "ate_rmse_m": float(ate_rmse(ref, est, align=align)),
        "rpe_trans_m": float(trans_rpe),
        "rpe_rot_deg": float(np.degrees(rot_rpe)),
        "aligned": bool(align),
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ATE/RPE between two TUM trajectory files")
    p.add_argument("estimate", help="estimated trajectory (TUM format)")
    p.add_argument("reference", help="reference trajectory (TUM format)")
    p.add_argument("--no-align", action="store_true",
                   help="skip SE(3) Umeyama alignment before ATE")
    p.add_argument("--max-stamp-diff", type=float, default=0.02,
                   help="max stamp distance for pose association [s]")
    p.add_argument("--rpe-delta", type=int, default=1,
                   help="frame delta for relative pose error")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    args = p.parse_args(argv)
    r = evaluate_files(args.estimate, args.reference,
                       align=not args.no_align,
                       max_stamp_diff=args.max_stamp_diff,
                       rpe_delta=args.rpe_delta)
    if args.json:
        print(json.dumps(r))
    else:
        print(f"matched {r['matched_poses']} poses"
              f" (align={'on' if r['aligned'] else 'off'})")
        print(f"ATE RMSE   {r['ate_rmse_m']:.4f} m")
        print(f"RPE trans  {r['rpe_trans_m']:.4f} m")
        print(f"RPE rot    {r['rpe_rot_deg']:.4f} deg")
    return r


if __name__ == "__main__":
    main()
