"""``BatchedOdometryRunner.run_device`` streams a batch one batched frame
at a time through a reused ring of two host slots (``parallel.batched.
_FrameRing``): held bit for bit to ``offline.pad_batch`` and the
padded-tensor runner, with the slots' stale rows, ``pipeline.Step``'s
refilled inputs, the spans a frame and the ``stream`` counter checked.

Imports no JAX; the card test at the end runs on an NVIDIA card with

    python -m pytest tests/test_torch_stream.py -m cuda --noconftest -q
"""

import re
import warnings

import numpy as np
import pytest
import torch

from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.models import pipeline
from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
from kinematic_icp_tpu_torch.utils import profiling, synthetic

# pytest-xdist runs several workers on the same cores
torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_torch_batched_exact.py's configuration and sensor
CFG = Config(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0,
             max_probes=4, deskew=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
MODES = {
    "default": {},
    "certified": dict(neighbor_candidates=27, exact_gn_reassociation=True,
                      gn_backend="cuda"),
    "pruned": dict(neighbor_candidates=27, exact_gn_reassociation=True,
                   gn_backend="torch", exact_prune_candidates=14),
    # a source capacity the scans overflow: the overflow totals differ
    # from zero
    "overflowing": dict(max_downsampled=128, max_source=16),
}
#: three drives of ragged lengths for a batch of four
LENGTHS = (8, 5, 6)
_OVERFLOW = re.compile(r"capacity overflow per sequence (.*) —")


@pytest.fixture(scope="module")
def drives():
    out = []
    for s, f in enumerate(LENGTHS):
        d = synthetic.make_sequence(f, world_seed=s, traj_seed=s + 10,
                                    noise_seed=s + 20,
                                    lidar=synthetic.LidarModel(**LIDAR))
        out.append({k: d[k] for k in ("frames", "rel_odometry",
                                      "extrinsic")})
    return out


@pytest.fixture
def empty_buffer():
    profiling._buffer.clear()
    yield profiling._buffer
    profiling._buffer.clear()


def _runs(drives):
    return [{"frames": d["frames"], "rel_odometry": d["rel_odometry"]}
            for d in drives]


def _whole_chunk(cfg, chunks, batch, extrinsic, device=CPU):
    """The padded path over ``chunks`` in turn, state carried: (poses of
    each sequence over the chunks, overflow (B, 3), counts (B, 4), the
    warnings' messages)."""
    state = toffline.init_batched_state(cfg, batch, device=device)
    run = toffline.make_batched_sequence_runner(cfg, device)
    ext = torch.from_numpy(np.asarray(extrinsic, np.float32)).to(device)
    poses = [[] for _ in range(batch)]
    overflow = np.zeros((batch, 3), np.int64)
    counts = np.zeros((batch, len(pipeline.COUNTS)), np.int64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for chunk in chunks:
            arrays = [torch.from_numpy(a).to(device)
                      for a in toffline.pad_batch(chunk, cfg, batch)]
            state, p, o, _, c = run(state, *arrays[:4], ext, arrays[4])
            p = p.cpu().numpy().astype(np.float64)
            for i in range(batch):
                f_i = (len(chunk[i]["frames"]) if i < len(chunk)
                       else len(p))
                poses[i].extend(p[:f_i, i])
            overflow += o.cpu().numpy()
            counts += c.cpu().numpy()
    return poses, overflow, counts, [str(w.message) for w in caught]


def _streamed(cfg, chunks, batch, extrinsic, device=CPU):
    """``run_device`` over ``chunks`` on one runner: (poses, overflow
    (B, 3) from its warnings, ``stats`` (B, 4), the other warnings'
    messages, the runner)."""
    runner = BatchedOdometryRunner(cfg, batch, extrinsic=extrinsic,
                                   device=device)
    overflow = np.zeros((batch, 3), np.int64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for chunk in chunks:
            poses = runner.run_device(chunk)
    other = []
    for w in caught:
        m = _OVERFLOW.search(str(w.message))
        if m:
            overflow += np.asarray(re.findall(r"\d+", m.group(1)),
                                   np.int64).reshape(batch, 3)
        else:
            other.append(str(w.message))
    stats = np.stack([runner.stats[k] for k in pipeline.COUNTS], -1)
    return poses, overflow, stats, other, runner


def _lengthened(drives, lane=1, frame=2):
    """The drives with one scan longer than ``CFG.max_points``: its
    points and stamps repeated past it."""
    runs = _runs(drives)
    frames = list(runs[lane]["frames"])
    p, t = frames[frame]
    reps = CFG.max_points // len(p) + 1
    frames[frame] = (np.concatenate([p] * reps), np.concatenate([t] * reps))
    runs[lane] = dict(runs[lane], frames=frames)
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_device_streams_the_whole_chunk_bits(drives, mode):
    """Ragged drives, fewer than the batch and one scan past
    ``max_points``: ``run_device`` gives the padded path's poses,
    overflow and counts bit for bit, and the same truncation warning."""
    cfg = CFG.replace(**MODES[mode])
    runs = _lengthened(drives)
    assert len(runs[1]["frames"][2][0]) > cfg.max_points
    want, w_over, w_counts, w_warn = _whole_chunk(
        cfg, [runs], 4, drives[0]["extrinsic"])
    got, g_over, g_stats, g_warn, _ = _streamed(
        cfg, [runs], 4, drives[0]["extrinsic"])
    for i in range(4):
        assert len(got[i]) == (LENGTHS[i] if i < 3 else max(LENGTHS))
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(want[i]))
    np.testing.assert_array_equal(g_over, w_over)
    np.testing.assert_array_equal(g_stats, w_counts)
    assert g_warn == w_warn
    assert len(g_warn) == 1 and "pad_sequence dropped" in g_warn[0]
    if mode == "overflowing":
        assert g_over.sum() > 0
    else:
        assert g_over.sum() == 0


def _shrunk(chunk, lane, keep):
    """``chunk`` with lane ``lane``'s scans cut to their first ``keep``
    points, every other one without stamps."""
    frames = [(p[:keep], t[:keep]) if k % 2 else p[:keep]
              for k, (p, t) in enumerate(chunk[lane]["frames"])]
    chunk = list(chunk)
    chunk[lane] = dict(chunk[lane], frames=frames)
    return chunk


def test_a_slot_reused_across_calls_leaves_no_stale_rows(drives):
    """Two ``run_device`` calls on one runner, lane 0's scans shrinking to
    a tenth in the second and losing stamps on every other frame: the
    slots hold what a fresh ``pad_batch`` of their last frames holds, and
    the poses are the padded path's."""
    runs = _runs(drives)
    first = [{k: r[k][:4] for k in r} for r in runs]
    second = _shrunk([{k: r[k][4:] for k in r} for r in runs], 0, 60)
    ext = drives[0]["extrinsic"]
    want, _, w_counts, _ = _whole_chunk(CFG, [first, second], 4, ext)
    got, _, g_stats, _, runner = _streamed(CFG, [first, second], 4, ext)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(want[i]))
    np.testing.assert_array_equal(g_stats, w_counts)
    padded = toffline.pad_batch(second, CFG, 4)
    last = len(padded[0]) - 1
    for f in (last - 1, last):
        slot = runner._ring.slots[f % 2]
        for held, a in zip(slot.arrays, padded[:4]):
            np.testing.assert_array_equal(held, a[f])
        for twin, a in zip(slot.twin, padded[:4]):
            np.testing.assert_array_equal(twin.numpy(), a[f])


def test_step_copies_a_twin_refilled_in_place(drives):
    """``pipeline.Step`` copies an input tensor again when it was refilled
    in place (its ``_version`` moved): two frames through the same tensors
    give the second frame's result, not a replay of the first."""
    runs = _runs(drives)[:2]
    padded = [torch.from_numpy(a)
              for a in toffline.pad_batch([{k: r[k][:2] for k in r}
                                           for r in runs], CFG, 2)]
    ext = torch.from_numpy(np.asarray(drives[0]["extrinsic"], np.float32))
    twin = tuple(torch.zeros_like(a[0]) for a in padded[:4])

    def frame(step, state, f, inputs):
        return step(state, *inputs, ext, padded[4][f])[0]

    state = toffline.init_batched_state(CFG, 2, device=CPU)
    step = pipeline.Step(CFG, donate=False, device=CPU)
    for t, a in zip(twin, padded):
        t.copy_(a[0])
    first = frame(step, state, 0, twin)
    for t, a in zip(twin, padded):
        t.copy_(a[1])
    second = frame(step, first, 1, twin)
    fresh = pipeline.Step(CFG, donate=False, device=CPU)
    want = frame(fresh, frame(fresh, state, 0, [a[0] for a in padded[:4]]),
                 1, [a[1] for a in padded[:4]])
    for g, w in zip(pipeline.state_tensors(second),
                    pipeline.state_tensors(want)):
        assert torch.equal(g, w)
    replay = frame(step, first, 1, [a[0] for a in padded[:4]])
    assert not torch.equal(second.pose, replay.pose)


def _inside(spans, outer):
    return [(s, e) for s, e in spans
            if any(os <= s and e <= oe for os, oe in outer)]


def test_each_streamed_frame_records_its_spans_and_the_stream_count(
        drives, empty_buffer):
    """Inside ``recording()``: one ``kicp.pad_batch`` and one
    ``kicp.upload`` a batched frame, inside ``kicp.frames``; one
    ``stream`` sample a ``run_device``, its ``frames`` the chunk's
    batched frames (no wait on the CPU's synchronous copies)."""
    runs = _runs(drives)
    chunks = [[{k: r[k][a:b] for k in r} for r in runs]
              for a, b in ((0, 3), (3, 8))]
    runner = BatchedOdometryRunner(CFG, 4, extrinsic=drives[0]["extrinsic"],
                                   device=CPU)
    with profiling.recording():
        for chunk in chunks:
            runner.run_device(chunk)
    spans = {}
    for name, start, v in empty_buffer:
        if "end_ns" in v:
            spans.setdefault(name, []).append((start, v["end_ns"]))
    assert len(spans["kicp.frames"]) == 2
    frames = [max(len(r["frames"]) for r in c) for c in chunks]
    assert frames == [3, 5]
    for name in ("kicp.pad_batch", "kicp.upload"):
        assert len(spans[name]) == sum(frames), name
        for outer, f in zip(sorted(spans["kicp.frames"]), frames):
            assert len(_inside(spans[name], [outer])) == f, name
    stream = [v for _, v in profiling.samples("stream")]
    assert stream == [{"frames": f, "waits": 0} for f in frames]


@pytest.mark.cuda
def test_run_device_streams_the_whole_chunk_bits_on_the_card(drives):
    """On a card (pinned slots, non-blocking copies, the slots' events):
    ``run_device`` over two chunks gives the padded path's bits, and the
    ``stream`` counter counts its batched frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph replays run only there")
    card = torch.device("cuda")
    runs = _runs(drives)
    chunks = [[{k: r[k][a:b] for k in r} for r in runs]
              for a, b in ((0, 4), (4, 8))]
    for mode in ("default", "certified"):
        cfg = CFG.replace(**MODES[mode])
        ext = drives[0]["extrinsic"]
        want, w_over, w_counts, _ = _whole_chunk(cfg, chunks, 4, ext, card)
        profiling._buffer.clear()
        with profiling.recording():
            got, g_over, g_stats, _, runner = _streamed(cfg, chunks, 4, ext,
                                                        card)
        assert runner._ring.slots[0].host[0].is_pinned()
        for i in range(4):
            np.testing.assert_array_equal(np.asarray(got[i]),
                                          np.asarray(want[i]), err_msg=mode)
        np.testing.assert_array_equal(g_over, w_over)
        np.testing.assert_array_equal(g_stats, w_counts)
        stream = [v for _, v in profiling.samples("stream")]
        assert [v["frames"] for v in stream] == [4, 4]
        assert all(0 <= v["waits"] <= v["frames"] for v in stream)
    profiling._buffer.clear()
