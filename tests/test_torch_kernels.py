"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

On a machine without a CUDA card every test here skips.
"""

import numpy as np
import pytest
import torch

from kinematic_icp_tpu_torch.ops import gn, hashmap, registration
from kinematic_icp_tpu_torch.ops.points import P3, transform

SOLVE = dict(voxel_size=1.0, max_num_iterations=10,
             convergence_criterion=0.001, use_adaptive_regularization=True,
             fixed_regularization=0.0, max_range=60.0)
MOTION = dict(voxel_size=1.0, max_probes=4, max_num_iterations=10,
              convergence_criterion=0.001,
              use_adaptive_odometry_regularization=True,
              fixed_regularization=0.0, threshold_max_range=60.0,
              exact_gn_reassociation=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _guess(dev, tx=0.02, ty=-0.01, yaw=0.01):
    c, s = np.cos(yaw), np.sin(yaw)
    return torch.tensor([[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, 0],
                         [0, 0, 0, 1]], dtype=torch.float32, device=dev)


def _scene(dev, n=512, nmap=3000, seed=0, k=20, extent=20.0, map_pts=None,
           src=None, mask=None):
    """A map of ``map_pts`` (uniform by default) and noisy map points as
    sources: (map, source P3, mask)."""
    rng = np.random.default_rng(seed)
    if map_pts is None:
        map_pts = rng.uniform(-extent, extent, (nmap, 3)).astype(np.float32)
    if src is None:
        src = (map_pts[rng.choice(len(map_pts), n, replace=n > len(map_pts))]
               + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    if mask is None:
        mask = rng.uniform(size=n) < 0.9
    m = hashmap.empty(1 << 13, k, device=dev)
    if len(map_pts):
        m = hashmap.insert(m, P3.from_array(torch.from_numpy(map_pts).to(dev)),
                           torch.ones(len(map_pts), dtype=torch.bool,
                                      device=dev), 1.0, 4)
    return (m, P3.from_array(torch.from_numpy(src).to(dev)),
            torch.from_numpy(mask).to(dev))


def _problem(dev, v, guess=None, **scene):
    """``_scene`` with candidates gathered at the guess."""
    m, source, mask = _scene(dev, **scene)
    guess = _guess(dev) if guess is None else guess
    cand = hashmap.gather_candidates(m, transform(guess, source), 1.0, 4, v)
    return cand, source, mask, guess


def _assert_kernel_matches_plain(cand, source, mask, guess, tau, **kw):
    kw = {**SOLVE, **kw}
    before = gn.LAUNCHES
    k = gn.gn_solve(cand, source, mask, guess, tau, **kw)
    assert gn.LAUNCHES == before + 1
    p = gn.gn_solve(cand, source, mask, guess, tau, backend="torch", **kw)
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before + 1
    # same per-element rounding (-fmad=false); sums in another order
    pk, pp = k[0].cpu().numpy(), p[0].cpu().numpy()
    np.testing.assert_allclose(pk, pp, atol=1e-5, rtol=0)
    for i in (1, 2, 4):
        assert int(k[i]) == int(p[i]), i
    diff = float(np.abs(pk - pp).max())
    tol = 1e-5 * abs(float(p[3])) + gn.error_tolerance(
        pp, guess.cpu().numpy(), kw["max_range"], diff)
    assert abs(float(k[3]) - float(p[3])) <= tol
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("max_it", [0, 1, 10])
@pytest.mark.parametrize("k", [8, 20, 32])  # 8: reduced candidates
@pytest.mark.parametrize("v", [1, 10, 27])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 8192])
def test_gn_kernel_table(card, n, v, k, max_it):
    # a dense map (~23 points a voxel), so 32-entry voxels fill past 20
    cand, source, mask, guess = _problem(card, v, n=n, nmap=12000, k=k,
                                         extent=4.0, seed=n + v + k)
    out = _assert_kernel_matches_plain(cand, source, mask, guess, 0.5,
                                       max_num_iterations=max_it)
    if max_it == 0:
        assert int(out[1]) == 0
    if n >= 33:
        assert int(out[2]) > n // 4


@pytest.mark.cuda
@pytest.mark.parametrize("v,crossing", [(10, False), (27, True)])
def test_gn_kernel_matches_plain(card, v, crossing):
    cand, source, mask, guess = _problem(card, v)
    k = _assert_kernel_matches_plain(cand, source, mask, guess, 0.5,
                                     check_crossing=crossing)
    assert int(k[2]) > 100


@pytest.mark.cuda
def test_gn_kernel_all_masked(card):
    cand, source, mask, guess = _problem(card, 10, n=300)
    out = _assert_kernel_matches_plain(cand, source, torch.zeros_like(mask),
                                       guess, 0.5)
    assert int(out[2]) == 0
    assert torch.equal(out[0], guess)


@pytest.mark.cuda
def test_gn_kernel_empty_map_fixed_regularization(card):
    rng = np.random.default_rng(1)
    src = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
    guess = _guess(card, 0.5, 0.0, 0.0)
    cand, source, mask, guess = _problem(
        card, 10, map_pts=np.zeros((0, 3), np.float32), src=src,
        mask=np.ones(256, bool), guess=guess)
    out = _assert_kernel_matches_plain(cand, source, mask, guess, 0.5,
                                       use_adaptive_regularization=False,
                                       fixed_regularization=0.1,
                                       max_range=0.0)
    assert int(out[1]) == 1 and int(out[2]) == 0 and float(out[3]) == 0.0
    assert torch.equal(out[0], guess)


def _margin_setup(n=400):
    """Points >= 0.21 from every voxel boundary, so small GN steps never
    change a query's voxel (the certificate holds)."""
    rng = np.random.default_rng(1234)
    base = rng.integers(-15, 15, (1200, 3)).astype(np.float32)
    frac = rng.uniform(0.21, 0.79, (1200, 3)).astype(np.float32)
    map_pts = np.unique(base + frac, axis=0)
    src = map_pts[:n] + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    src = np.clip(src - np.floor(src), 0.21, 0.79) + np.floor(src)
    return map_pts, src.astype(np.float32), np.ones(n, bool)


@pytest.mark.cuda
def test_gn_kernel_check_crossing_holds(card):
    map_pts, src, mask = _margin_setup()
    cand, source, mask, guess = _problem(
        card, 27, map_pts=map_pts, src=src, mask=mask,
        guess=_guess(card, 1e-4, 0.0, 0.0))
    out = _assert_kernel_matches_plain(cand, source, mask, guess, 0.7,
                                       check_crossing=True)
    assert not bool(out[4])


@pytest.mark.cuda
def test_gn_kernel_check_crossing_violated(card):
    cand, source, mask, guess = _problem(card, 27, seed=2,
                                         guess=_guess(card, 0.45, 0.0, 0.0))
    out = _assert_kernel_matches_plain(cand, source, mask, guess, 2.0,
                                       check_crossing=True)
    assert bool(out[4])


@pytest.mark.cuda
@pytest.mark.parametrize("v,crossing", [(10, False), (27, True)])
def test_gn_kernel_deterministic(card, v, crossing):
    cand, source, mask, guess = _problem(card, v, n=8192, nmap=12000,
                                         extent=4.0)
    a = gn.gn_solve(cand, source, mask, guess, 0.5, check_crossing=crossing,
                    **SOLVE)
    b = gn.gn_solve(cand, source, mask, guess, 0.5, check_crossing=crossing,
                    **SOLVE)
    torch.cuda.synchronize()
    for x, y in zip(a, b):  # bit-equal, the error included
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_gn_kernel_spreads_over_ctas(card):
    cand, source, mask, guess = _problem(card, 10, n=8192, nmap=12000,
                                         extent=4.0)
    gn.gn_solve(cand, source, mask, guess, 0.5, **SOLVE)
    torch.cuda.synchronize()
    # one CTA per 32-query tile while the card holds them all at once
    assert 1 < gn.LAST_CTAS <= 8192 // 32


def _batch(dev, b, n, v=10):
    """B problems of one N, each with its own map, sources and guess,
    stacked into one batched call's arguments (and the single ones)."""
    singles = [_problem(dev, v, n=n, nmap=12000, extent=4.0, seed=100 + i,
                        guess=_guess(dev, 0.02 + 0.03 * i, -0.01 * i,
                                     0.01 + 0.004 * i))
               for i in range(b)]
    cand = hashmap.CandidateSet(*(torch.stack(t) for t in
                                  zip(*(p[0] for p in singles))))
    source = P3(*(torch.stack(t) for t in zip(*(p[1] for p in singles))))
    return (cand, source, torch.stack([p[2] for p in singles]),
            torch.stack([p[3] for p in singles])), singles


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("n", [1024, 8192])
def test_gn_kernel_batch_bit_equal_to_single_launches(card, n, b):
    """B frames in one launch, each bit-equal to its own launch: a frame's
    sums run in an order set by its N alone (at N=8192 and B=8 the 2,048
    tiles outnumber the co-resident CTAs, so CTAs walk several tiles)."""
    (cand, source, mask, guess), singles = _batch(card, b, n)
    tau = torch.full((b,), 0.5, device=card)
    before = (gn.LAUNCHES, gn.FRAMES)
    out = gn.gn_solve(cand, source, mask, guess, tau, **SOLVE)
    assert (gn.LAUNCHES, gn.FRAMES) == (before[0] + 1, before[1] + b)
    assert out[0].shape == (b, 4, 4) and out[1].shape == (b,)
    plain = gn.gn_solve(cand, source, mask, guess, tau, backend="torch",
                        **SOLVE)
    for i, (c, s, m, g) in enumerate(singles):
        one = gn.gn_solve(c, s, m, g, 0.5, **SOLVE)
        for x, y in zip(out, one):
            assert torch.equal(x[i].reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8))
        for j in (1, 2, 4):
            assert int(out[j][i]) == int(plain[j][i])
    np.testing.assert_allclose(out[0].cpu().numpy(), plain[0].cpu().numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("crossing", [False, True])
def test_gn_kernel_splits_more_frames_than_resident_ctas(card, crossing):
    """B = capacity + 1 frames at N = 1024: two launches (capacity frames,
    then one), each frame bit-equal to its own single launch."""
    cap = gn.capacity(card, crossing)
    (cand, source, mask, guess), singles = _batch(card, 4, 1024)
    b = cap + 1
    pick = torch.arange(b, device=card) % 4  # four distinct problems
    args = [t[pick].contiguous() for t in (*cand, *source, mask, guess)]
    tau = torch.full((b,), 0.5, device=card)
    before = (gn.LAUNCHES, gn.FRAMES)
    out = gn.gn_solve(hashmap.CandidateSet(*args[:5]), P3(*args[5:8]),
                      args[8], args[9], tau, check_crossing=crossing,
                      **SOLVE)
    torch.cuda.synchronize()
    assert (gn.LAUNCHES, gn.FRAMES) == (before[0] + 2, before[1] + b)
    assert out[0].shape == (b, 4, 4)
    ones = [gn.gn_solve(c, s, m, g, 0.5, check_crossing=crossing, **SOLVE)
            for c, s, m, g in singles]
    for i in range(b):
        for x, y in zip(out, ones[i % 4]):
            assert torch.equal(x[i].reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8)), i


@pytest.mark.cuda
def test_batched_drive_equals_one_run_per_sequence(card):
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import (init_batched_state,
                                                 make_batched_sequence_runner,
                                                 pad_batch, run_offline)
    from kinematic_icp_tpu_torch.utils import synthetic

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True)
    seqs = [synthetic.make_sequence(5, world_seed=s, traj_seed=s + 10,
                                    noise_seed=s + 20) for s in range(3)]
    arrays = [torch.from_numpy(a).to(card) for a in pad_batch(seqs, cfg)]
    before = (gn.LAUNCHES, gn.FRAMES)
    _, poses, overflow, _ = make_batched_sequence_runner(cfg, card)(
        init_batched_state(cfg, 3, device=card), *arrays[:4],
        torch.eye(4, device=card), arrays[4])
    assert (gn.LAUNCHES, gn.FRAMES) == (before[0] + 5, before[1] + 15)
    for i, s in enumerate(seqs):
        single, _, stats = run_offline(s["frames"], s["rel_odometry"], cfg,
                                       return_stats=True)
        np.testing.assert_array_equal(
            poses[:, i].cpu().numpy().astype(np.float64), single)
        np.testing.assert_array_equal(overflow[i].cpu().numpy(),
                                      stats["overflow"])


def _motion(dev, scene, guess, tau, **kw):
    m, source, mask = scene
    return registration.compute_robot_motion(
        m, source, mask, torch.eye(4, device=dev), guess,
        torch.tensor(tau, dtype=torch.float32, device=dev),
        **{**MOTION, **kw})


def _assert_same_solve(a, b):
    assert torch.equal(a[0], b[0])
    assert int(a[1].iterations) == int(b[1].iterations)
    assert int(a[1].num_correspondences) == int(b[1].num_correspondences)


@pytest.mark.cuda
@pytest.mark.parametrize("crosses", [False, True],
                         ids=["certificate-holds", "certificate-fails"])
def test_certified_exact_against_full_loop(card, crosses):
    """The certified solve (the kernel's check_crossing instance) against
    the full-27 loop on the card: equal on a passing frame, the loop's
    result itself on a frame that falls back."""
    if crosses:
        scene = _scene(card, seed=2)
        guess, tau = _guess(card, 0.45, 0.0, 0.0), 2.0
    else:
        map_pts, src, mask = _margin_setup()
        scene = _scene(card, map_pts=map_pts, src=src, mask=mask)
        guess, tau = _guess(card, 1e-4, 0.0, 0.0), 0.7
    before = (gn.LAUNCHES, gn.CROSSING_LAUNCHES)
    cert = _motion(card, scene, guess, tau, gn_backend="cuda")
    assert (gn.LAUNCHES, gn.CROSSING_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    loop = _motion(card, scene, guess, tau, gn_backend="torch")
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before[0] + 1
    assert bool(cert[1].exact_fallback) == crosses
    assert loop[1].exact_fallback is None
    if crosses:
        _assert_same_solve(cert, loop)
    else:
        # kernel vs loop: same rounding per element, sums in another order
        np.testing.assert_allclose(cert[0].cpu().numpy(),
                                   loop[0].cpu().numpy(), atol=1e-5, rtol=0)
        assert int(cert[1].iterations) == int(loop[1].iterations)
        assert int(cert[1].num_correspondences) == int(
            loop[1].num_correspondences)
    assert torch.isfinite(cert[1].odometry_error_pt)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [8, 14, 22])
def test_pruned_exact_equals_full_loop(card, v):
    scene = _scene(card, seed=3)
    for tau, tx in ((0.3, 0.08), (1.5, 0.08), (2.0, 0.45)):
        guess = _guess(card, tx, 0.0, 0.0)
        pruned = _motion(card, scene, guess, tau, gn_backend="torch",
                         exact_prune_candidates=v)
        _assert_same_solve(pruned, _motion(card, scene, guess, tau,
                                           gn_backend="torch"))


@pytest.mark.cuda
def test_pruned_exact_corner_voxel_falls_back(card):
    """The only map point lies in a corner voxel, which V=14 skips."""
    scene = _scene(card, map_pts=np.array([[-0.01, -0.01, -0.01]],
                                          np.float32),
                   src=np.array([[0.5, 0.5, 0.5]], np.float32),
                   mask=np.ones(1, bool))
    guess = _guess(card, 0.0, 0.0, 0.0)
    pruned = _motion(card, scene, guess, 1.0, gn_backend="torch",
                     exact_prune_candidates=14)
    assert bool(pruned[1].exact_fallback)
    assert int(pruned[1].num_correspondences) == 1
    _assert_same_solve(pruned, _motion(card, scene, guess, 1.0,
                                       gn_backend="torch"))


@pytest.mark.cuda
def test_gn_kernel_rejects_bad_input(card):
    cand, source, mask, guess = _problem(card, 10, n=64, nmap=300)
    with pytest.raises(ValueError):
        gn.gn_solve(cand, source, mask, guess.half(), 0.5, **SOLVE)
    with pytest.raises(ValueError):
        gn.gn_solve(cand._replace(words=cand.words.transpose(1, 2)), source,
                    mask, guess, 0.5, **SOLVE)


def _packed_frame(codec, bucket=1024, n=1000, seed=0):
    from kinematic_icp_tpu_torch.utils import packing

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    pts[:4] = [[1e-40, -0.0, np.inf], [np.nan, -np.inf, 3.14],
               [-1e-45, 0.0, 1e38], [65504.0, -7.25, 2.0 ** -126]]
    ts = rng.uniform(0, 1, n).astype(np.float32)
    rel = (np.eye(4) + rng.normal(0, 0.01, (4, 4))).astype(np.float32)
    buf, _ = packing.pack_frame(pts, ts, rel, bucket, codec)
    return torch.from_numpy(buf.view(np.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("active", [False, True])
def test_unpack_frame_on_card_bit_equal_to_cpu(card, active):
    """The f32 codec decodes by reinterpreting views: the card's unpack is
    bit-equal to the CPU's, special floats included."""
    from kinematic_icp_tpu_torch.utils import packing

    buf = _packed_frame("f32")
    cpu = packing.unpack_frame(buf, 1024, "f32", return_active=active)
    dev = packing.unpack_frame(buf.to(card), 1024, "f32",
                               return_active=active)
    for a, b in zip(cpu, dev):
        b = b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def _served(card, blocking, frames=5, stream_chunk=2):
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(frames)
    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True)
    s = LidarOdometryServer(cfg, extrinsic=seq["extrinsic"],
                            stream_chunk=stream_chunk, device=card)
    for i, (p, t) in enumerate(seq["frames"]):
        s.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * (i + 1),
                         blocking=blocking)
    s.drain()
    return s


@pytest.mark.cuda
def test_cuda_server_streaming_bit_equal_to_blocking(card):
    blocking = _served(card, True)
    streamed = _served(card, False)
    a = np.asarray([p for _, p in blocking.poses_with_stamps])
    b = np.asarray([p for _, p in streamed.poses_with_stamps])
    np.testing.assert_array_equal(a, b)
    assert streamed.overflow_stats == blocking.overflow_stats
    assert blocking.frames_registered == 4  # frame 0 is stationary


@pytest.mark.cuda
def test_served_frame_launches_gn_kernel_once(card):
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import synthetic

    seq = synthetic.make_sequence(2)
    s = LidarOdometryServer(
        Config(max_points=4096, max_downsampled=4096, max_source=1024,
               map_capacity=1 << 13, max_range=60.0, deskew=True),
        extrinsic=seq["extrinsic"])
    s.warmup(4096)
    before = gn.LAUNCHES
    res = s.register_frame(seq["frames"][1][0], seq["frames"][1][1],
                           seq["rel_odometry"][1], stamp=0.1)
    assert res["registered"] and np.isfinite(res["pose"]).all()
    assert gn.LAUNCHES == before + 1


#: the headline shape (chip_smoke.py's HEADLINE)
HEADLINE = dict(max_points=65536, max_downsampled=8192, max_source=1024,
                map_capacity=5 << 14, max_probes=5, voxel_size=1.0,
                max_range=60.0, deskew=True)


@pytest.mark.cuda
def test_float64_server_registers_every_frame_on_the_kernel(card):
    """A float64 state's frames go through the kernel (cast to float32, as
    its plain version casts), one launch each, within 5 mm ATE of the
    float32 server."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.server import LidarOdometryServer
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    seq = synthetic.make_sequence(20, lidar=synthetic.realistic_lidar(),
                                  clear_path_margin=3.0)
    poses = {}
    for dtype in (torch.float32, torch.float64):
        s = LidarOdometryServer(Config(**HEADLINE), extrinsic=seq["extrinsic"],
                                dtype=dtype, device=card)
        before = gn.LAUNCHES
        for i, (p, t) in enumerate(seq["frames"]):
            s.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * i)
        assert s.frames_registered == 19
        assert gn.LAUNCHES - before == s.frames_registered
        assert s.state.pose.dtype == dtype
        poses[dtype] = np.asarray([p for _, p in s.poses_with_stamps])
    assert np.isfinite(poses[torch.float64]).all()
    assert ate_rmse(list(poses[torch.float32]), list(poses[torch.float64]),
                    align=False) < 5e-3


@pytest.mark.cuda
def test_cli_drive_launches_gn_once_a_frame(card, tmp_path):
    from kinematic_icp_tpu_torch import run_odometry
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.io.tum import read_tum

    seq = synthetic.make_sequence(10)
    bag = str(tmp_path / "drive.mcap")
    synthetic.write_sequence_to_mcap(seq, bag)
    timings = {}
    before = gn.LAUNCHES
    out = run_odometry.main([bag, "--max-points", "8192", "--no-progress"],
                            timings=timings)
    stamps, poses = read_tum(out)
    assert len(poses) == timings["frames"] == 10
    assert np.isfinite(np.asarray(poses)).all()
    # frame 0 is stationary (identity odometry): 9 registered frames
    assert gn.LAUNCHES - before == 9


@pytest.mark.cuda
def test_native_library_loads_on_the_card_host(card):
    from kinematic_icp_tpu_torch import baseline_native
    from kinematic_icp_tpu_torch.utils.io import native

    assert native.get_lib() is not None
    assert baseline_native.available()
