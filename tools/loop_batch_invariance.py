"""Does a batch move the loop lowering's bits?  Which op, and at what cost.

Usage (on a machine with a CUDA card, from this checkout's root):

    python3 tools/loop_batch_invariance.py [OTHER_ROOT] [--frames 20]
        [--diagnose-frames 8] [--repeats 5]

For each root (this checkout alone, or, given ``OTHER_ROOT`` -- another
checkout, for instance the parent commit unpacked with ``git archive`` into
``chip_checkout/`` -- in the order other, this, this, other), a subprocess
imports that root's ``kinematic_icp_tpu_torch`` and, on the card:

  1. probe: ``torch.sum(-1)`` (and ``points.row_sum`` where the root has
     it) over (B, N) float32 rows, B = 1, 2, 4, 8, 16, N = 1024 and 8192:
     how many rows are bit-equal to the same row summed alone;
  2. diagnose (the first run of each root): ``chip_smoke.py``'s headline
     drives 0-3 under ``gn_backend="torch"`` (the GN loop lowering),
     ``pipeline.register_frame`` op by op at B = 4 and, from each row of
     the same state, each drive at B = 1.  A ``TorchDispatchMode`` records
     every aten op's float inputs and outputs at B = 4 and holds each B = 1
     op to its row: an op whose output differs while its float inputs are
     equal is a root cause, reported with its code line, the frames where
     it was one and the largest difference.  Each frame starts every B = 1
     run from the B = 4 state's row, so every frame is diagnosed;
  3. loop: the same drives over ``--frames`` frames through
     ``offline.make_batched_sequence_runner`` (CUDA graph replays) at
     B = 4 and at B = 1 a drive: the frames bit-equal to B = 1 by drive,
     and the B = 4 run's ms a batched frame (inputs on the card before the
     clock, poses read back inside it), ``--repeats`` times;
  4. sharded_1rank: drives 0-1 (``chip_smoke.SHARD_BATCH``) over the
     frames through ``parallel.sharded.make_sharded_sequence_runner`` on a
     one-rank NCCL group, which runs the loop lowering inside one graph a
     frame: ms a batched frame, ``--repeats`` times, as ``chip_smoke.py``'s
     graph phase times it.

Prints one JSON line a run, then one line of the medians by root, then the
card's ``nvidia-smi`` name and power limit.  ``--device cpu`` rehearses the
same program on small drives (``tools/sharded_scaling.py``'s CPU config,
gloo for the one-rank group).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: drives of the loop check, and the probe's batches and row lengths
BATCH = 4
PROBE_BATCHES = (1, 2, 4, 8, 16)
PROBE_LENGTHS = (1024, 8192)


def _chip_smoke():
    """This checkout's chip_smoke (configs, drives), importing the package
    from whichever root is first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _bits(t):
    import torch

    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _same(a, b):
    import torch

    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def probe(torch, points, dev):
    """Rows of a (B, N) sum bit-equal to the row summed alone."""
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {"torch.sum": lambda x: x.sum(-1)}
    if hasattr(points, "row_sum"):
        sums["points.row_sum"] = points.row_sum
    out = {}
    for name, fn in sums.items():
        for n in PROBE_LENGTHS:
            x = torch.randn(max(PROBE_BATCHES), n, generator=gen,
                            device=dev)
            alone = torch.stack([fn(x[i:i + 1])[0]
                                 for i in range(max(PROBE_BATCHES))])
            out[f"{name} N={n}"] = {
                f"B={b}": sum(_same(r, a) for r, a in
                              zip(fn(x[:b]), alone[:b]))
                for b in PROBE_BATCHES}
    return out


def _floats(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _row(t4, t1, row):
    """Row ``row`` of a B = BATCH value against its B = 1 counterpart:
    the value itself where the shapes agree (no batch axis), else the
    slice of the one axis that is BATCH times longer; None otherwise."""
    if t4.shape == t1.shape:
        return t4
    if t4.dim() != t1.dim():
        return None
    for d in range(t4.dim()):
        if (t4.shape[d] == BATCH * t1.shape[d]
                and t4.shape[:d] + t4.shape[d + 1:]
                == t1.shape[:d] + t1.shape[d + 1:]):
            return t4.unflatten(d, (BATCH, t1.shape[d])).select(d, row)
    return None


def _where():
    """The innermost line of the package on the stack."""
    for fr in reversed(traceback.extract_stack()):
        if "kinematic_icp_tpu_torch" in fr.filename:
            rel = fr.filename.split("kinematic_icp_tpu_torch" + os.sep)[-1]
            return f"{rel}:{fr.lineno} {fr.name}"
    return "?"


def _modes():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        """Every aten op's float inputs and outputs, cloned, in order."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = [t.clone() for t in _floats((args, kwargs))]
            out = func(*args, **kwargs)
            self.ops.append((str(func), ins,
                             [t.clone() for t in _floats(out)]))
            return out

    class Compare(TorchDispatchMode):
        """Hold each op of a B = 1 run to its row of a Record."""

        def __init__(self, ops, row, frame, causes):
            super().__init__()
            self.ops, self.row, self.frame = ops, row, frame
            self.causes = causes
            self.j = 0
            self.diverged = None
            self.uncomparable = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = [t.clone() for t in _floats((args, kwargs))]
            out = func(*args, **kwargs)
            if self.diverged is None:
                self._check(str(func), ins, _floats(out))
            self.j += 1
            return out

        def _check(self, name, ins, outs):
            if self.j >= len(self.ops) or self.ops[self.j][0] != name:
                self.diverged = {"op": self.j, "name": name,
                                 "where": _where()}
                return
            _, rins, routs = self.ops[self.j]
            rows = [_row(a, b, self.row) for a, b in zip(routs, outs)]
            if any(r is None for r in rows):
                self.uncomparable += 1
                return
            if all(_same(r, b) for r, b in zip(rows, outs)):
                return
            rin = [_row(a, b, self.row) for a, b in zip(rins, ins)]
            if not all(r is not None and _same(r, b)
                       for r, b in zip(rin, ins)):
                return  # an earlier op's difference carried along
            key = f"{name} @ {_where()}"
            diff = max(float((r.double() - b.double()).abs().max())
                       for r, b in zip(rows, outs))
            c = self.causes.setdefault(key, {"frames": set(), "ops": 0,
                                             "max_abs": 0.0,
                                             "first": [self.frame, self.j]})
            c["frames"].add(self.frame)
            c["ops"] += 1
            c["max_abs"] = max(c["max_abs"], diff)

    return Record, Compare


def diagnose(torch, cfg, arrays, ext, frames):
    """Root-cause ops of B = BATCH against B = 1, op by op (see the module
    docstring).  ``arrays``: the padded (F, B, ...) inputs on the card."""
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import (_per_frame_constants,
                                                 init_batched_state)
    from kinematic_icp_tpu_torch.ops import hashmap, threshold

    Record, Compare = _modes()
    pts, ts, mask, has_ts, rels = arrays
    causes = {}
    info = {"frames": frames, "diverged": [], "uncomparable_ops": 0,
            "ops_a_frame": []}
    # the per-frame constants (before the frame loop), held the same way
    rec = Record()
    with rec:
        active, twists = _per_frame_constants(rels, ext, cfg)
    for i in range(BATCH):
        one = rels[:, i:i + 1]
        with Compare(rec.ops, i, -1, causes):
            _per_frame_constants(one, ext, cfg)
    state = init_batched_state(cfg, BATCH, device=ext.device)

    def inputs(f, rows):
        """Frame ``f``'s inputs of ``rows``, sliced outside the modes."""
        return [pts[f, rows], ts[f, rows], mask[f, rows], has_ts[f, rows],
                ext, rels[f, rows]], dict(
                    config=cfg, active=active[f, rows],
                    rel_twist_in_lidar=None if twists is None
                    else twists[f, rows])

    for f in range(frames):
        args, kw = inputs(f, slice(None))
        rec = Record()
        with rec:
            nxt, _ = pipeline.register_frame(state, *args, **kw)
        info["ops_a_frame"].append(len(rec.ops))
        for i in range(BATCH):
            one = pipeline.OdometryState(
                pose=state.pose[i:i + 1].clone(),
                map=hashmap.MapState(
                    table=state.map.table[i:i + 1].clone(),
                    bucket_slots=state.map.bucket_slots),
                threshold=threshold.ThresholdState(
                    *(t[i:i + 1].clone() for t in state.threshold)))
            args, kw = inputs(f, slice(i, i + 1))
            cmp = Compare(rec.ops, i, f, causes)
            with cmp:
                pipeline.register_frame(one, *args, **kw)
            info["uncomparable_ops"] += cmp.uncomparable
            if cmp.diverged is not None:
                info["diverged"].append({"frame": f, "row": i,
                                         **cmp.diverged})
        del rec
        state = nxt
        torch.cuda.empty_cache()
    ordered = sorted(causes.items(), key=lambda kv: kv[1]["first"])
    info["root_causes"] = [
        {"op": k, "frames": sorted(v["frames"]), "ops": v["ops"],
         "max_abs": v["max_abs"], "first_frame_op": v["first"]}
        for k, v in ordered]
    return info


def _timed(sync, run, repeats, frames):
    """ms a batched frame of ``run()`` (which reads its poses back)."""
    ms = []
    out = None
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        out = run()
        ms.append((time.perf_counter() - t0) * 1e3 / frames)
    return ms, out


def one_root(root, out_path, frames, diagnose_frames, repeats, device):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    cs = _chip_smoke()
    small = device == "cpu"
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import (init_batched_state,
                                                 make_batched_sequence_runner,
                                                 pad_batch)
    from kinematic_icp_tpu_torch.ops import points
    from kinematic_icp_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh, sharded,
                                                  shutdown_distributed)

    if not os.path.abspath(points.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {points.__file__}, not {root}'s")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    row = {"root": root, "device": device, "probe": probe(torch, points, dev)}
    if small:
        # a rehearsal: tools/sharded_scaling.py's CPU drives and config
        sys.path.insert(0, os.path.join(HERE, "tools"))
        from sharded_scaling import SMALL, SMALL_LIDAR

        from kinematic_icp_tpu_torch.utils import synthetic

        seqs = [synthetic.make_sequence(
            frames, world_seed=s, traj_seed=s + 10, noise_seed=s + 20,
            lidar=synthetic.LidarModel(**SMALL_LIDAR)) for s in range(BATCH)]
        shape = SMALL
    else:
        seqs = [cs.headline_drive(s) for s in range(BATCH)]
        shape = cs.HEADLINE
    runs = [{"frames": s["frames"][:frames],
             "rel_odometry": s["rel_odometry"][:frames]} for s in seqs]
    ext = torch.tensor(np.asarray(seqs[0]["extrinsic"], np.float32),
                       device=dev)
    lowering = Config(**shape, gn_backend="torch")
    arrays = [torch.from_numpy(a).to(dev) for a in pad_batch(runs, lowering)]
    if diagnose_frames:
        with torch.no_grad():
            row["diagnosis"] = diagnose(torch, lowering, arrays, ext,
                                        diagnose_frames)

    runner = make_batched_sequence_runner(lowering, dev)

    def loop(b, cols):
        state = init_batched_state(lowering, b, device=dev)
        out = runner(state, *(a[:, cols] for a in arrays[:4]), ext,
                     arrays[4][:, cols])
        return out[1].cpu().numpy()

    loop(BATCH, slice(None))  # captures the B = BATCH frame
    ms, batched = _timed(sync, lambda: loop(BATCH, slice(None)), repeats,
                         frames)
    alone = [loop(1, slice(i, i + 1))[:, 0] for i in range(BATCH)]
    row["loop"] = {
        "B": BATCH, "frames": frames, "ms_per_batched_frame": ms,
        "frames_bit_equal_to_b1_by_drive": [
            sum(bool(np.array_equal(batched[f, i], alone[i][f]))
                for f in range(frames)) for i in range(BATCH)],
        "max_abs_vs_b1": float(max(np.abs(batched[:, i] - alone[i]).max()
                                   for i in range(BATCH)))}

    cfg = Config(**shape)
    b = cs.SHARD_BATCH
    initialize_distributed(f"localhost:{cs.free_port()}", 1, 0,
                           backend="gloo" if small else "nccl")
    try:
        mesh = make_mesh(1, 1, device)
        srun = sharded.make_sharded_sequence_runner(cfg, mesh)

        def shard(n):
            state = sharded.init_sharded_state(cfg, mesh, b)
            out = srun(state, *(a[:n, :b] for a in arrays[:4]), ext,
                       arrays[4][:n, :b])
            return out[1].cpu().numpy()

        shard(3)  # captures the frame on NCCL
        sms, sposes = _timed(sync, lambda: shard(frames), repeats, frames)
    finally:
        shutdown_distributed()
    row["sharded_1rank"] = {"B": b, "frames": frames,
                            "ms_per_batched_frame": sms,
                            "finite": bool(np.isfinite(sposes).all())}
    with open(out_path, "w") as fh:
        json.dump(row, fh)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another checkout's root")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--diagnose-frames", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal on small drives (gloo)")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:
        return one_root(args.run, args.out, args.frames,
                        args.diagnose_frames, args.repeats, args.device)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("loop_batch_invariance: no CUDA card", file=sys.stderr)
        return 1
    roots = ([os.path.abspath(args.other), HERE, HERE,
              os.path.abspath(args.other)] if args.other else [HERE])
    rows, seen = [], set()
    with tempfile.TemporaryDirectory() as tmp:
        for k, root in enumerate(roots):
            out = os.path.join(tmp, f"{k}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--run", root,
                   "--out", out, "--frames", str(args.frames),
                   "--diagnose-frames",
                   str(0 if root in seen else args.diagnose_frames),
                   "--repeats", str(args.repeats), "--device", args.device]
            seen.add(root)
            subprocess.run(cmd, check=True, timeout=1200)
            with open(out) as fh:
                rows.append(json.load(fh))
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for r in rows:
        s = summary.setdefault(r["root"], {"loop_ms": [], "sharded_ms": [],
                                           "loop_bit_equal_by_drive": []})
        s["loop_ms"] += r["loop"]["ms_per_batched_frame"]
        s["sharded_ms"] += r["sharded_1rank"]["ms_per_batched_frame"]
        s["loop_bit_equal_by_drive"].append(
            r["loop"]["frames_bit_equal_to_b1_by_drive"])
    for s in summary.values():
        for key in ("loop_ms", "sharded_ms"):
            v = sorted(s[key])
            s[key + "_median"] = v[len(v) // 2]
            s[key + "_range"] = [v[0], v[-1]]
            del s[key]
    print(json.dumps({"summary": summary}), flush=True)
    if args.device == "cuda":
        print(_chip_smoke().nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
