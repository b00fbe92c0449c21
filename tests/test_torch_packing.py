"""Port vs JAX: the frame upload codec (host pack, device unpack)."""

import warnings

import jax
import numpy as np
import pytest
import torch

from kinematic_icp_tpu.utils import packing as jpk
from kinematic_icp_tpu_torch.utils import packing as tpk

torch.set_num_threads(1)


def _frame(n, seed=0, with_ts=True, special=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    if special:
        pts[:4] = [[1e-40, -0.0, np.inf], [np.nan, -np.inf, 3.14],
                   [-1e-45, 0.0, 1e38], [65504.0, -7.25, 2.0 ** -126]]
    ts = rng.uniform(0, 1, n).astype(np.float32) if with_ts else None
    rel = np.eye(4) + rng.normal(0, 0.01, (4, 4))
    return pts, ts, rel


#: (points, bucket): a partly filled bucket, a frame truncated to its
#: bucket (one stamp per point), an empty frame
CASES = {"partial": (1000, 1024), "truncated": (300, 256), "empty": (0, 64)}


@pytest.mark.parametrize("with_ts", [True, False], ids=["ts", "no_ts"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("codec", tpk.CODECS)
def test_host_pack_same_bytes_as_jax(codec, case, with_ts):
    n, bucket = CASES[case]
    pts, ts, rel = _frame(n, seed=n, with_ts=with_ts)
    jbuf, jn = jpk.pack_frame(pts, ts, rel, bucket, codec)
    tbuf, tn = tpk.pack_frame(pts, ts, rel, bucket, codec)
    assert tn == jn == min(n, bucket)
    assert tbuf.dtype == np.uint16
    assert tbuf.shape == (tpk.packed_words(bucket, codec),)
    np.testing.assert_array_equal(tbuf, jbuf)
    assert tpk.packed_bytes(bucket, codec) == jpk.packed_bytes(bucket, codec)


def _unpack_both(buf, bucket, codec):
    jout = jax.jit(lambda b: jpk.unpack_frame(b, bucket, codec,
                                              return_active=True))(buf)
    tout = tpk.unpack_frame(torch.from_numpy(buf.view(np.int16)), bucket,
                            codec, return_active=True)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def _assert_header_fields_equal(j, t):
    np.testing.assert_array_equal(t[2], j[2])               # mask (count)
    assert bool(t[3]) == bool(j[3])                         # has_ts
    np.testing.assert_array_equal(t[4].view(np.uint32),     # rel, bit-equal
                                  j[4].view(np.uint32))
    assert bool(t[5]) == bool(j[5])                         # active


def test_unpack_f32_bit_equal_to_jax_special_floats():
    pts, ts, rel = _frame(1000, special=True)
    buf, _ = jpk.pack_frame(pts, ts, rel, 1024, "f32")
    j, t = _unpack_both(buf, 1024, "f32")
    for a, b in zip(j[:2], t[:2]):  # points, timestamps: bit for bit
        assert b.dtype == a.dtype == np.float32
        np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))
    np.testing.assert_array_equal(t[0][:1000].view(np.uint32),
                                  pts.view(np.uint32))
    _assert_header_fields_equal(j, t)
    assert t[2].sum() == 1000 and bool(t[3]) and bool(t[5])


@pytest.mark.parametrize("case", sorted(CASES))
def test_unpack_u16_within_one_rounding_of_jax(case):
    """``offset + q * scale``: XLA on the CPU may fuse it into one
    multiply-add, the port rounds the product first, so points agree to
    one ulp of the product plus one of the result (many ulps of a result
    near zero, where offset and product cancel); the timestamps, one
    multiply, bit for bit."""
    n, bucket = CASES[case]
    pts, ts, rel = _frame(n, seed=n + 1)
    buf, _ = jpk.pack_frame(pts, ts, rel, bucket, "u16")
    j, t = _unpack_both(buf, bucket, "u16")
    body = buf[jpk.HEADER_WORDS:jpk.HEADER_WORDS + 3 * bucket]
    scale = buf[42:48].view(np.float32)
    prod = body.reshape(bucket, 3).astype(np.float32) * scale
    tol = np.spacing(np.abs(prod)) + np.spacing(np.abs(t[0]))
    assert (np.abs(t[0] - j[0]) <= tol).all()
    np.testing.assert_array_equal(t[1].view(np.uint32), j[1].view(np.uint32))
    _assert_header_fields_equal(j, t)
    if n:
        span = pts.max(axis=0) - pts.min(axis=0)
        k = min(n, bucket)
        err = np.abs(t[0][:k] - pts[:k])
        assert (err <= span / 65535.0 * 0.5 + 60 * 4 * 2.0 ** -23).all()


@pytest.mark.parametrize("codec", tpk.CODECS)
def test_inactive_pad_row_unpacks_identity_rel(codec):
    buf = np.zeros(tpk.packed_words(256, codec), np.uint16)
    j, t = _unpack_both(buf, 256, codec)
    _assert_header_fields_equal(j, t)
    np.testing.assert_array_equal(t[4], np.eye(4, dtype=np.float32))
    assert not t[2].any() and not bool(t[3]) and not bool(t[5])
    np.testing.assert_array_equal(t[0], j[0])


def test_timestamps_must_be_one_per_point():
    """A known difference (ROADMAP C): JAX's codec enables deskew whenever
    there are at least as many stamps as points; the port only for exactly
    one stamp per point.  On matching lengths the two agree bit for bit."""
    pts, ts, rel = _frame(10, seed=3)
    longer = np.concatenate([ts, [0.5, 0.25]]).astype(np.float32)
    for codec in tpk.CODECS:
        tbuf, _ = tpk.pack_frame(pts, longer, rel, 64, codec)
        jbuf, _ = jpk.pack_frame(pts, longer, rel, 64, codec)
        assert tbuf[2] == 0 and jbuf[2] == 1
        tbuf, _ = tpk.pack_frame(pts, ts[:8], rel, 64, codec)
        jbuf, _ = jpk.pack_frame(pts, ts[:8], rel, 64, codec)
        assert tbuf[2] == jbuf[2] == 0
        np.testing.assert_array_equal(tbuf, jbuf)
        j, t = _unpack_both(tbuf, 64, codec)
        assert not bool(t[3])


def test_unpack_rejects_a_wrong_buffer():
    buf = torch.zeros(tpk.packed_words(64, "f32"), dtype=torch.int16)
    with pytest.raises(ValueError):
        tpk.unpack_frame(buf, 128, "f32")
    with pytest.raises(ValueError):
        tpk.unpack_frame(buf.to(torch.int32), 64, "f32")
    with pytest.raises(ValueError):
        tpk.packed_words(64, "f16")


#: tests/test_torch_server.py's configuration, four frames of its drive
#: (frame 0 is stationary, frames 1-3 register)
RULE_CFG = dict(max_points=4096, max_downsampled=4096, max_source=1024,
                map_capacity=1 << 13, max_range=60.0, deskew=True)
RULE_FRAMES = 4


def _stamp_rule_drives(stamps):
    """The drive's poses through ``run_offline``, the server,
    ``BatchedOdometryRunner.step`` and ``BatchedOdometryRunner.run_device``,
    each scan carrying ``stamps(t)`` in place of its own per-point stamps t
    (None: no stamps)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import run_offline
    from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(RULE_FRAMES)
    cfg, ext, rels = Config(**RULE_CFG), seq["extrinsic"], seq["rel_odometry"]
    frames = [(p, None if stamps is None else stamps(t))
              for p, t in seq["frames"]]
    offline, _ = run_offline(frames, rels, cfg, extrinsic=ext, device="cpu")
    server = LidarOdometryServer(cfg, extrinsic=ext, device="cpu")
    for i, (p, t) in enumerate(frames):
        server.register_frame(p, t, rels[i], stamp=0.1 * (i + 1))
    served = np.asarray([p for _, p in server.poses_with_stamps])
    runs = [{"frames": frames, "rel_odometry": rels}]
    stepped = np.asarray(BatchedOdometryRunner(
        cfg, 1, extrinsic=ext, device="cpu").run(runs)[0])
    streamed = np.asarray(BatchedOdometryRunner(
        cfg, 1, extrinsic=ext, device="cpu").run_device(runs)[0])
    return {"run_offline": offline, "server": served, "step": stepped,
            "run_device": streamed}


@pytest.fixture(scope="module")
def stamp_rule_reference():
    return {"none": _stamp_rule_drives(None),
            "per_point": _stamp_rule_drives(lambda t: t)}


@pytest.mark.parametrize("extra", [1, -1], ids=["one_more", "one_fewer"])
def test_every_entry_point_deskews_only_one_stamp_per_point(
        stamp_rule_reference, extra):
    """One rule on every entry point (ROADMAP C, fixed): a scan whose stamps
    are not one per point runs without deskew, bit-equal to the same scan
    without stamps, through ``run_offline``, the server and
    ``BatchedOdometryRunner.step`` and ``run_device`` alike (one stamp
    fewer used to raise a broadcast error in ``step``; one more used to
    deskew in ``run_offline`` and ``step`` and not in the server)."""
    def off_by_one(t):
        return (np.concatenate([t, [0.5]]).astype(np.float32) if extra > 0
                else t[:-1])

    got = _stamp_rule_drives(off_by_one)
    none, per_point = (stamp_rule_reference[k] for k in ("none", "per_point"))
    for path, poses in got.items():
        assert poses.shape == (RULE_FRAMES, 4, 4)
        np.testing.assert_array_equal(poses, none[path], err_msg=path)
        # the deskew moves the drive: the rule decides the poses
        assert np.abs(per_point[path] - none[path]).max() > 1e-4, path
    for path in ("server", "step", "run_device"):
        np.testing.assert_allclose(got[path], got["run_offline"], atol=1e-5,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("path", ["run_offline", "run_device", "step",
                                  "server"])
def test_every_entry_point_warns_and_counts_a_cut_scan(path):
    """A scan past ``max_points`` loses its tail on every entry point, and
    each warns once with the points it cut (``BatchedOdometryRunner.step``
    used to cut them silently); the server also keeps the count in
    ``overflow_stats``."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import run_offline
    from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(RULE_FRAMES)
    cfg, ext, rels = Config(**RULE_CFG), seq["extrinsic"], seq["rel_odometry"]
    frames = list(seq["frames"])
    p, t = frames[2]  # a frame that registers
    reps = cfg.max_points // len(p) + 1
    frames[2] = (np.concatenate([p] * reps), np.concatenate([t] * reps))
    size = len(frames[2][0])
    cut = size - cfg.max_points
    runs = [{"frames": frames, "rel_odometry": rels}]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if path == "run_offline":
            run_offline(frames, rels, cfg, extrinsic=ext, device="cpu")
        elif path == "server":
            server = LidarOdometryServer(cfg, extrinsic=ext, device="cpu")
            for i, (p, t) in enumerate(frames):
                server.register_frame(p, t, rels[i], stamp=0.1 * (i + 1))
            assert server.overflow_stats["points_truncated"] == cut
        else:
            runner = BatchedOdometryRunner(cfg, 1, extrinsic=ext,
                                           device="cpu")
            getattr(runner, "run" if path == "step" else path)(runs)
    want = {"server": f"scan has {size} points > Config.max_points="
                      f"{cfg.max_points}; {cut} dropped",
            # ``step`` sees one frame of its one lane at a time
            "step": f"pad_sequence dropped {cut} points from 1/1 scans"
            }.get(path, f"pad_sequence dropped {cut} points from 1/"
                        f"{RULE_FRAMES} scans")
    messages = [str(w.message) for w in caught]
    assert cut > 0 and sum(want in m for m in messages) == 1, messages


def _ragged_batch():
    """Three sequences of 3, 2 and 4 frames for a batch of four: scans of
    one stamp a point or none, growing and shrinking, one past 16 points,
    and a scan without stamps where the ring's slot last held one with
    (frames f and f + 2 share a slot)."""
    rng = np.random.default_rng(7)
    #: (points, stamped) of each frame of each sequence
    spec = (((5, True), (20, False), (3, False)),
            ((9, False), (4, True)),
            ((12, True), (2, False), (16, False), (7, True)))

    def scan(k, stamped):
        pts = rng.uniform(-30, 30, (k, 3)).astype(np.float32)
        return pts, (rng.uniform(0, 1, k).astype(np.float32) if stamped
                     else None)

    return [{"frames": [scan(*fr) for fr in frames],
             "rel_odometry": [np.eye(4) + rng.normal(0, 0.01, (4, 4))
                              for _ in frames]}
            for frames in spec]


def _pack_every_way(seqs, cfg, batch):
    """Frame f's (points, stamps, mask, has_ts) (B, N, ...) rows as
    ``pad_batch``, ``run_device``'s ring and ``BatchedOdometryRunner.step``
    write them, each a list over frames."""
    import torch

    from kinematic_icp_tpu_torch.offline import pad_batch
    from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
    from kinematic_icp_tpu_torch.parallel.batched import _FrameRing

    num = max(len(s["frames"]) for s in seqs)
    padded = pad_batch(seqs, cfg, batch)
    ring = _FrameRing(batch, cfg.max_points, torch.device("cpu"))
    stepped = []
    runner = BatchedOdometryRunner(cfg, batch, device="cpu")

    def spy(state, *inputs, active):
        stepped.append([x.numpy() for x in inputs[:4]])
        return state, None

    runner._frame = spy
    runner.run(seqs)
    return {"pad_batch": [[a[f] for a in padded[:4]] for f in range(num)],
            "ring": [[x.numpy().copy() for x in twin]
                     for twin in ring.frames(seqs, num)],
            "step": stepped}


def test_pad_sequence_differs_from_jax_on_extra_stamps():
    """The deliberate difference from JAX, pinned: JAX's ``pad_sequence``
    (and its batched ``step``) enables deskew for at least as many stamps
    as points; the port only for exactly one stamp per point.  With one
    stamp a point or none, every writer of padded rows (``pad_sequence``,
    ``pad_batch``, ``run_device``'s ring and ``BatchedOdometryRunner.
    step``) writes JAX's ``pad_sequence`` rows bit for bit over a ragged
    batch."""
    from kinematic_icp_tpu import Config as JConfig
    from kinematic_icp_tpu.offline import pad_sequence as jpad
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import pad_sequence as tpad

    pts, ts, rel = _frame(10, seed=5)
    frames = [(pts, np.concatenate([ts, [0.5]]).astype(np.float32)),
              (pts, ts)]
    j = jpad(frames, [rel, rel], JConfig(max_points=16))
    t = tpad(frames, [rel, rel], Config(max_points=16))
    assert j[3].tolist() == [True, True]
    assert t[3].tolist() == [False, True]
    for i in (0, 2, 4):  # points, mask, odometry
        np.testing.assert_array_equal(j[i], t[i])
    np.testing.assert_array_equal(j[1][1], t[1][1])  # the per-point stamps

    n, batch = 16, 4
    seqs = _ragged_batch()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the scan past n
        want = [jpad(s["frames"], s["rel_odometry"], JConfig(max_points=n))
                for s in seqs]
        for s, w in zip(seqs, want):
            for a, b in zip(tpad(s["frames"], s["rel_odometry"],
                                 Config(max_points=n)), w):
                np.testing.assert_array_equal(a, b)
        got = _pack_every_way(seqs, Config(max_points=n), batch)
    for f in range(4):
        rows = [np.zeros((batch, *a.shape[1:]), a.dtype) for a in want[0][:4]]
        for i, w in enumerate(want):
            if f < len(w[0]):
                for r, a in zip(rows, w[:4]):
                    r[i] = a[f]
        for writer, frames in got.items():
            for r, a in zip(rows, frames[f]):
                np.testing.assert_array_equal(a, r, err_msg=writer)
