"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

On a machine without a CUDA card every test here skips.
"""

import functools

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
    _, poses, overflow, *_ = make_batched_sequence_runner(cfg, card)(
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


@pytest.mark.cuda
def test_batched_certified_exact_one_launch_a_frame(card, monkeypatch):
    """The certified exact mode under a batch: one launch of the
    ``check_crossing`` instance a batched frame, the full-27 loop on the
    batched frames where some row's certificate failed, each drive within
    5 mm of its own ``run_offline``."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import (init_batched_state,
                                                 make_batched_sequence_runner,
                                                 pad_batch, run_offline)
    from kinematic_icp_tpu_torch.utils import synthetic
    from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True,
                 neighbor_candidates=27, exact_gn_reassociation=True)
    seqs = [synthetic.make_sequence(6, world_seed=s, traj_seed=s + 10,
                                    noise_seed=s + 20) for s in range(3)]
    arrays = [torch.from_numpy(a).to(card) for a in pad_batch(seqs, cfg)]
    counts = _count_on_device(monkeypatch, card)
    runner = make_batched_sequence_runner(cfg, card)
    runner.step.release()  # captured again under the counting wrappers
    for _ in range(2):  # the first run captures
        counts.zero_()
        before = (gn.LAUNCHES, gn.CROSSING_LAUNCHES)
        _, poses, overflow, fallbacks, _ = runner(
            init_batched_state(cfg, 3, device=card), *arrays[:4],
            torch.eye(4, device=card), arrays[4])
    assert (gn.LAUNCHES, gn.CROSSING_LAUNCHES) == (before[0] + 6,
                                                  before[1] + 6)
    # the full-27 loop ran on exactly the batched frames some row crossed
    loops, _, crossed = counts.tolist()
    assert loops == crossed <= 6 and (loops > 0 or not fallbacks.any())
    assert not overflow.any()
    for i, s in enumerate(seqs):
        single = run_offline(s["frames"], s["rel_odometry"], cfg)[0]
        got = poses[:, i].cpu().numpy().astype(np.float64)
        assert ate_rmse(list(single), list(got), align=False) < 5e-3


@pytest.mark.cuda
def test_sharded_one_rank_nccl_bit_equal_to_unsharded_loop(card):
    """A one-rank NCCL group and a (1, 1) mesh on the card: the sharded
    runner (no GN kernel, by design) bit-equal to the unsharded runner's
    loop lowering."""
    import socket

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.parallel import (BatchedOdometryRunner,
                                                  initialize_distributed,
                                                  make_mesh,
                                                  shutdown_distributed)
    from kinematic_icp_tpu_torch.utils import synthetic

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True)
    runs = [{k: s[k] for k in ("frames", "rel_odometry")}
            for s in (synthetic.make_sequence(5, world_seed=w,
                                              traj_seed=w + 10,
                                              noise_seed=w + 20)
                      for w in range(2))]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        before = gn.LAUNCHES
        got = BatchedOdometryRunner(cfg, 2, mesh=make_mesh(1, 1)).run_device(
            runs)
        assert gn.LAUNCHES == before
    finally:
        shutdown_distributed()
    want = BatchedOdometryRunner(cfg.replace(gn_backend="torch"), 2,
                                 device=card).run_device(runs)
    for i in range(2):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]))


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


def _nn_kernel_and_plain(m, q, mask):
    """``hashmap.nearest_neighbor`` at V = 27 on the card (one launch of
    ``csrc/nn27.cu``) and its plain version on the same inputs."""
    from kinematic_icp_tpu_torch.ops import nn27

    before = nn27.LAUNCHES
    kernel = hashmap.nearest_neighbor(m, q, mask, 1.0, 4)
    assert nn27.LAUNCHES == before + 1
    plain = hashmap.nn_from_candidates(
        hashmap.gather_candidates(m, q, 1.0, 4, 27), q, mask, 1.0)
    torch.cuda.synchronize()
    return kernel, plain


def _assert_nn_bit_equal(m, q, mask):
    """The kernel's (nearest, dist) bit-equal to the plain version's on the
    live queries, in the queries' type; on the others dist inf and the
    query itself."""
    (kn, kd), (pn, pd) = _nn_kernel_and_plain(m, q, mask)
    for name, a, b in zip(("x", "y", "z", "dist"), (*kn, kd), (*pn, pd)):
        assert a.dtype == b.dtype == q.x.dtype, name
        assert torch.equal(_bits(a[mask]), _bits(b[mask])), name
    assert torch.isinf(kd[~mask]).all() and torch.isinf(pd[~mask]).all()
    for a, b in zip(kn, q):
        assert torch.equal(a[~mask], b[~mask])
    return kd


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nn27_kernel_bit_equal_to_plain(card, b, n, dtype):
    """Dense maps (~23 points a voxel, so voxels fill their 20 entries),
    90 % live queries near the map and a few far from it, at B = 1 (an
    unbatched table) and B = 8 (each row its own map); float32 queries,
    and float64 ones (a float64 state: the guess applied in float64)."""
    rng = np.random.default_rng(n + b)
    maps, qs, masks = [], [], []
    for i in range(b):
        m, source, mask = _scene(card, n=n, nmap=12000, extent=4.0,
                                 seed=n + 10 * i)
        q = transform(_guess(card).to(dtype), source.astype(dtype))
        far = torch.from_numpy(rng.uniform(size=n) < 0.05).to(card)
        q = P3(*(torch.where(far, c + 50.0, c) for c in q))
        maps.append(m.table)
        qs.append(q)
        masks.append(mask)
    if b == 1:
        m, q, mask = hashmap.MapState(maps[0], 4), qs[0], masks[0]
    else:
        m = hashmap.MapState(torch.stack(maps), 4)
        q = P3(*(torch.stack(c) for c in zip(*qs)))
        mask = torch.stack(masks)
    dist = _assert_nn_bit_equal(m, q, mask)
    assert torch.isfinite(dist).sum() > mask.sum() // 2
    assert torch.isinf(dist[mask]).any()  # the far queries find nothing


def _nn_case(dev, case, dtype=torch.float32):
    """(map, queries, mask) of one edge case of the full-27 search, the
    queries in ``dtype``."""
    m = hashmap.empty(1 << 13, 20, device=dev)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3.0, 3.0, (2000, 3)).astype(np.float32)
    q = pts[:512] + rng.normal(0, 0.2, (512, 3)).astype(np.float32)
    mask = rng.uniform(size=512) < 0.5
    if case == "empty_map":
        pts = pts[:0]
    elif case == "all_masked":
        mask[:] = False
    elif case == "full_bucket":
        # 16 buckets of 4 slots for ~200 voxels: every bucket fills
        m = hashmap.empty(64, 20, device=dev)
    elif case == "ties":
        # a point repeated within its voxel (entry lanes tie), and the two
        # quantization centres nearest a voxel face on either side of it
        # (offset ids tie), with queries on the face
        c = np.float32(1.0 / 2048.0)
        pair = np.array([[1.0 - c, 0.5, 0.5], [1.0 + c, 0.5, 0.5]],
                        np.float32)
        pts = np.concatenate([np.repeat(pts[:1], 3, 0), pair, pts[1:]])
        q[:2] = [[1.0, 0.5 + c, 0.5 + c], pts[0]]
        mask[:2] = True
    m = hashmap.insert(m, P3.from_array(torch.from_numpy(pts).to(dev)),
                       torch.ones(len(pts), dtype=torch.bool, device=dev),
                       1.0, 4) if len(pts) else m
    return (m, P3.from_array(torch.from_numpy(q).to(dev, dtype)),
            torch.from_numpy(mask).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_map", "all_masked", "full_bucket",
                                  "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nn27_kernel_edge_cases_bit_equal_to_plain(card, case, dtype):
    m, q, mask = _nn_case(card, case, dtype)
    if case == "full_bucket":
        assert (hashmap.slot_counts(m) > 0).all()
    dist = _assert_nn_bit_equal(m, q, mask)
    if case == "empty_map":
        assert torch.isinf(dist).all()
    if case == "ties":
        # the face query is 1/2048 from both centres
        assert float(dist[0]) == 1.0 / 2048.0 and torch.isfinite(dist[1])


@pytest.mark.cuda
def test_nn27_kernel_rejects_bad_input(card):
    from kinematic_icp_tpu_torch.ops import nn27

    m, q, mask = _nn_case(card, "ties")
    with pytest.raises(ValueError):
        nn27.nearest_neighbor(m, q, mask.to(torch.int32), 1.0)
    with pytest.raises(ValueError):
        nn27.nearest_neighbor(m, P3(*(c[None] for c in q)), mask[None], 1.0)
    with pytest.raises(ValueError):  # no half-precision instance
        nn27.nearest_neighbor(m, q.astype(torch.float16), mask, 1.0)
    with pytest.raises(ValueError):  # planes of two types
        nn27.nearest_neighbor(m, P3(q.x, q.y, q.z.double()), mask, 1.0)


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


# --- the compiled step: CUDA graph capture and replay -------------------


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _count_on_device(monkeypatch, dev):
    """Wrap ``registration.run_gn`` and ``compute_robot_motion`` to count,
    in a device tensor, [GN loops run, associations made, registrations
    whose fallback flags have a row set].  The counts are device ops where
    the work is, inside whatever conditional node holds it, so a replay
    counts what it ran; a capture's warm-up counts too (zero the tensor
    after a capture)."""
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    run_gn, motion = registration.run_gn, registration.compute_robot_motion

    def counting_run_gn(associate, *args, **kw):
        counts[0].add_(1)

        def counted(pose):
            counts[1].add_(1)
            return associate(pose)

        return run_gn(counted, *args, **kw)

    def counting_motion(*args, **kw):
        pose, debug = motion(*args, **kw)
        if debug.exact_fallback is not None:
            counts[2].add_(debug.exact_fallback.any().to(torch.int64))
        return pose, debug

    monkeypatch.setattr(registration, "run_gn", counting_run_gn)
    monkeypatch.setattr(registration, "compute_robot_motion",
                        counting_motion)
    return counts


@pytest.mark.cuda
def test_cooperative_gn_launch_captured_and_replayed(card):
    """The GN kernel's cooperative launch inside a CUDA graph: a replay
    gives the eager launch's bits and counts one launch; 1,000 replays of
    the same inputs give the same bits (each launch zeroes its own barrier
    words, which sit at one address in the graph)."""
    from kinematic_icp_tpu_torch.utils.cuda_graph import StaticCall

    cand, source, mask, guess = _problem(card, 10, n=1024, nmap=12000,
                                         extent=4.0)
    tau = torch.tensor(0.5, device=card)
    eager = gn.gn_solve(cand, source, mask, guess, tau, **SOLVE)
    call = StaticCall(lambda *a: gn.gn_solve(
        hashmap.CandidateSet(*a[:5]), P3(*a[5:8]), a[8], a[9], a[10],
        **SOLVE), (*cand, *source, mask, guess, tau), capture=True)
    before = gn.LAUNCHES
    call.prepare()
    assert gn.LAUNCHES == before  # warm-up and capture are not counted
    for i in range(1000):
        out = call()
        if i in (0, 999):
            torch.cuda.synchronize()
            for x, y in zip(out, eager):
                assert torch.equal(_bits(x), _bits(y)), i
    assert gn.LAUNCHES == before + 1000


@pytest.mark.cuda
def test_capture_survives_an_earlier_graph_in_a_reference_cycle(card):
    """An earlier owner's captured graph left in a reference cycle, and a
    collection during the next capture (``fn`` runs one whenever the
    collector is on, as an allocation may): the capture holds the
    collector off, so no graph is reset while the stream captures."""
    import gc

    from kinematic_icp_tpu_torch.utils.cuda_graph import StaticCall

    def collect_then(x):
        if torch.cuda.is_current_stream_capturing() and gc.isenabled():
            gc.collect()
        return (x + 1.0) * 3.0

    gc.collect()
    old = StaticCall(lambda x: x * 2.0, [torch.ones(8, device=card)], True)
    old()
    cycle = [old]
    cycle.append(cycle)
    del old, cycle
    x = torch.arange(8.0, device=card)
    call = StaticCall(collect_then, [x], True)
    for _ in range(2):
        out = call()
    torch.cuda.synchronize()
    assert call.graphs == 1 and gc.isenabled()
    assert torch.equal(out, (torch.arange(8.0, device=card) + 1.0) * 3.0)


def _headline_drive(frames, seed=0):
    from kinematic_icp_tpu_torch.utils import synthetic

    return synthetic.make_sequence(frames, world_seed=seed,
                                   traj_seed=seed + 10, noise_seed=seed + 20,
                                   lidar=synthetic.realistic_lidar(),
                                   clear_path_margin=3.0)


def _run(card, seqs, cfg, eager, count=None):
    """The batched runner (``seqs`` a list) or the sequence runner (one
    dict), graph or ``eager``: (poses as numpy, GN launches)."""
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import (
        init_batched_state, make_batched_sequence_runner,
        make_sequence_runner, pad_batch, pad_sequence)

    batched = isinstance(seqs, list)
    if batched:
        arrays = pad_batch(seqs, cfg)
        runner = make_batched_sequence_runner(cfg, card, eager=eager)
        state = init_batched_state(cfg, len(seqs), device=card)
        ext = seqs[0]["extrinsic"]
    else:
        arrays = pad_sequence(seqs["frames"], seqs["rel_odometry"], cfg)
        runner = make_sequence_runner(cfg, card, eager=eager)
        state = pipeline.init_state(cfg, device=card)
        ext = seqs["extrinsic"]
    arrays = [torch.from_numpy(a).to(card) for a in arrays]
    before = gn.LAUNCHES
    _, poses, overflow, *_ = runner(
        state, *arrays[:4], torch.tensor(np.asarray(ext, np.float32),
                                         device=card), arrays[4])
    torch.cuda.synchronize()
    assert not overflow.any()
    return poses.cpu().numpy(), gn.LAUNCHES - before


@pytest.mark.cuda
def test_released_step_captures_again(card):
    """A step whose graphs were freed (``Step.release``, as a process
    group's teardown does) captures again at its next call, into a new
    memory pool, and replays the same bits."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import pad_sequence

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True,
                 neighbor_candidates=27, exact_gn_reassociation=True,
                 exact_prune_candidates=14, gn_backend="torch")
    seq = _headline_drive(3)
    pts, ts, mask, has_ts, rels = (
        torch.from_numpy(a).to(card)
        for a in pad_sequence(seq["frames"], seq["rel_odometry"], cfg))
    ext = torch.tensor(np.asarray(seq["extrinsic"], np.float32),
                       device=card)
    step = pipeline.Step(cfg, device=card, donate=False)
    runs = []
    for _ in range(2):
        state = pipeline.init_state(cfg, device=card)
        for f in range(3):
            state, _ = step(state, pts[f], ts[f], mask[f], has_ts[f], ext,
                            rels[f])
        runs.append(_bits(state.pose))
        pool = step.pool
        step.release()
        assert [c.graphs for c in step.calls] == [0] and step.pool != pool
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_headline_drive_replayed_bit_equal_to_eager(card):
    """20 headline frames: one graph replay a frame, every pose bit-equal
    to the eager loop's, one GN launch a frame either way; a second
    sequence of the same shapes replays the same graph."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import make_sequence_runner

    cfg = Config(**HEADLINE)
    seq = _headline_drive(20)
    eager, eager_launches = _run(card, seq, cfg, eager=True)
    graph, graph_launches = _run(card, seq, cfg, eager=False)
    assert eager_launches == graph_launches == 20
    np.testing.assert_array_equal(graph, eager)
    step = make_sequence_runner(cfg, card)
    again, _ = _run(card, seq, cfg, eager=False)
    np.testing.assert_array_equal(again, eager)
    assert step is make_sequence_runner(cfg, card)


@pytest.mark.cuda
def test_loop_lowering_batch_bit_equal_to_each_drive_alone(card):
    """Four headline drives, 20 frames, through the GN loop lowering
    (``gn_backend="torch"``: the sharded path's, pruned exact's and the
    certified fallback's solve) at B = 4 and each alone at B = 1: every
    frame bit-equal (its float sums are ``points.row_sum``'s fixed tree;
    with ``torch.sum`` 71 of 80 frames were)."""
    from kinematic_icp_tpu_torch import Config

    cfg = Config(**HEADLINE, gn_backend="torch")
    seqs = [_headline_drive(20, seed=s) for s in range(4)]
    batched, launches = _run(card, seqs, cfg, eager=False)
    assert launches == 0
    for i, s in enumerate(seqs):
        alone, _ = _run(card, [s], cfg, eager=False)
        np.testing.assert_array_equal(batched[:, i], alone[:, 0])


@pytest.mark.cuda
def test_batched_drive_replayed_bit_equal_to_eager(card):
    """Eight distinct headline drives, 10 frames: one GN launch a batched
    frame, graph and eager bit-equal."""
    from kinematic_icp_tpu_torch import Config

    cfg = Config(**HEADLINE)
    seqs = [_headline_drive(10, s) for s in range(8)]
    eager, eager_launches = _run(card, seqs, cfg, eager=True)
    graph, graph_launches = _run(card, seqs, cfg, eager=False)
    assert eager_launches == graph_launches == 10
    np.testing.assert_array_equal(graph, eager)


@pytest.mark.cuda
def test_batch_past_capacity_captured_with_both_launches(card):
    """A batch of the co-resident CTA count plus one: each batched frame
    replays both GN launches, bit-equal to the eager loop."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.utils import synthetic

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 12, max_range=60.0, deskew=True)
    b = gn.capacity(card, False) + 1
    drives = [synthetic.make_sequence(3, world_seed=s, traj_seed=s + 10,
                                      noise_seed=s + 20) for s in range(3)]
    seqs = [drives[i % 3] for i in range(b)]
    eager, eager_launches = _run(card, seqs, cfg, eager=True)
    graph, graph_launches = _run(card, seqs, cfg, eager=False)
    assert eager_launches == graph_launches == 2 * 3
    np.testing.assert_array_equal(graph, eager)


@pytest.mark.cuda
def test_step_replayed_1000_times_gives_the_same_bits(card):
    """One captured headline frame replayed 1,000 times from the same
    state (``make_step(donate=False)`` copies it in each call): the same
    pose, solve and map table every time."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import pad_sequence

    cfg = Config(**HEADLINE)
    seq = _headline_drive(3)
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a).to(card) for a in
                                   pad_sequence(seq["frames"],
                                                seq["rel_odometry"], cfg))
    ext = torch.tensor(np.asarray(seq["extrinsic"], np.float32), device=card)
    state, _ = pipeline.register_frame(
        pipeline.init_state(cfg, device=card), pts[1], ts[1], mask[1],
        has_ts[1], ext, rels[1], cfg)
    args = (state, pts[2], ts[2], mask[2], has_ts[2], ext, rels[2])
    want_state, want = pipeline.register_frame(*args, cfg)
    step = pipeline.make_step(cfg, donate=False, device=card)
    before = gn.LAUNCHES
    for i in range(1000):
        got_state, got = step(*args)
        if i % 100 == 0 or i == 999:
            for x, y in ((got_state.pose, want_state.pose),
                         (got_state.map.table, want_state.map.table),
                         (got.debug.iterations, want.debug.iterations),
                         (got.debug.odometry_error_pt,
                          want.debug.odometry_error_pt),
                         (got.overflow, want.overflow)):
                assert torch.equal(_bits(x), _bits(y)), i
    assert gn.LAUNCHES == before + 1000


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["blocking", "scan"])
def test_served_drive_replayed_bit_equal_to_eager(card, mode):
    """20 headline frames through the server, blocking and chunk-scan:
    graph replays bit-equal to the eager steps, one GN launch a registered
    frame (the scan's padding rows included)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.server import LidarOdometryServer

    seq = _headline_drive(20)
    poses, launches = {}, {}
    for eager in (True, False):
        s = LidarOdometryServer(Config(**HEADLINE), extrinsic=seq["extrinsic"],
                                stream_mode="steps" if mode == "blocking"
                                else "scan", stream_chunk=8, device=card,
                                eager=eager)
        s.warmup(len(seq["frames"][0][0]), streaming=mode == "scan")
        before = gn.LAUNCHES
        for i, (p, t) in enumerate(seq["frames"]):
            s.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * i,
                             blocking=mode == "blocking")
        s.drain()
        launches[eager] = gn.LAUNCHES - before
        poses[eager] = np.asarray([p for _, p in s.poses_with_stamps])
    np.testing.assert_array_equal(poses[False], poses[True])
    assert launches[False] == launches[True] == (
        19 if mode == "blocking" else 24)


# --- the exact modes' frames as graph segments around their read-back ----

#: chip_smoke.py's exact configuration (the JAX bench's, bench.py:296-298)
EXACT = dict(HEADLINE, neighbor_candidates=27, exact_gn_reassociation=True,
             map_capacity=1 << 16, max_probes=4)


def _exact_frames(card, cfg, seqs, eager, count, counts):
    """``count`` frames of one drive (a dict) or a batch of drives (a
    list) through a fresh ``pipeline.Step`` (captured ahead, on a copy of
    the state; no frame syncs the host) or ``register_frame`` (``eager``).
    Returns, a frame each: the pose's bits, the fallback flags, the GN
    loops and associations the frame ran (``counts``, from
    ``_count_on_device``), its ``check_crossing`` launches, its
    iterations and correspondences, and its counts row."""
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import (init_batched_state,
                                                 pad_batch, pad_sequence)

    batched = isinstance(seqs, list)
    if batched:
        arrays = pad_batch([{k: s[k][:count] for k in ("frames",
                                                       "rel_odometry")}
                            for s in seqs], cfg)
        state = init_batched_state(cfg, len(seqs), device=card)
        ext = seqs[0]["extrinsic"]
    else:
        arrays = pad_sequence(seqs["frames"][:count],
                              seqs["rel_odometry"][:count], cfg)
        state = pipeline.init_state(cfg, device=card)
        ext = seqs["extrinsic"]
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a).to(card)
                                   for a in arrays)
    ext = torch.tensor(np.asarray(ext, np.float32), device=card)
    if eager:
        register = functools.partial(pipeline.register_frame, config=cfg)
    else:
        register = pipeline.Step(cfg, device=card)
        register(pipeline.clone_state(state), pts[0], ts[0], mask[0],
                 has_ts[0], ext, rels[0])
        assert [c.graphs for c in register.calls] == [1]
    frames = []
    for f in range(count):
        counts.zero_()
        before = gn.CROSSING_LAUNCHES
        torch.cuda.set_sync_debug_mode("default" if eager else "error")
        try:
            state, out = register(state, pts[f], ts[f], mask[f], has_ts[f],
                                  ext, rels[f])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        frames.append((_bits(state.pose).cpu(),
                       out.debug.exact_fallback.cpu(),
                       *counts[:2].tolist(),
                       gn.CROSSING_LAUNCHES - before,
                       out.debug.iterations.cpu(),
                       out.debug.num_correspondences.cpu(),
                       out.counts.cpu()))
    return frames


@pytest.mark.cuda
@pytest.mark.parametrize("mode,batch", [("certified", 0), ("pruned", 0),
                                        ("certified", 4)])
def test_exact_frames_replayed_bit_equal_to_eager(card, monkeypatch, mode,
                                                 batch):
    """The certified (one drive and B = 4) and pruned exact modes through
    the step: one graph a frame, no host sync, every frame's pose
    bit-equal to the eager frame's with the same fallback flags.  The
    fallback's full-27 loop (a conditional node) runs on exactly the
    frames whose flag is set, and the replay's ``check_crossing`` launches
    equal eager's; where eager runs every trip of every loop, the replay
    associates 1 + (iterations - 1) of the slowest row a loop, fewer."""
    from kinematic_icp_tpu_torch import Config

    cfg = Config(**EXACT)
    if mode == "pruned":
        cfg = cfg.replace(exact_prune_candidates=14, gn_backend="torch")
    count = 20
    seqs = ([_headline_drive(count, s) for s in range(batch)] if batch
            else _headline_drive(count))
    counts = _count_on_device(monkeypatch, card)
    eager = _exact_frames(card, cfg, seqs, True, count, counts)
    graph = _exact_frames(card, cfg, seqs, False, count, counts)
    for f, (e, g) in enumerate(zip(eager, graph)):
        assert torch.equal(e[0], g[0]), f
        assert torch.equal(e[1], g[1]), f
        fell = int(g[1].any())
        loops = fell + (mode == "pruned")
        assert e[2] == g[2] == loops, f
        assert e[3] == 10 * loops and g[3] <= e[3], f
        assert e[4] == g[4] == int(mode == "certified"), f
    assert any(g[1].any() for g in graph)  # the fallback ran
    assert sum(g[3] for g in graph) < sum(e[3] for e in eager)


@pytest.mark.cuda
def test_certified_batch_on_nn27_replayed_equal_to_eager_and_plain(
        card, monkeypatch):
    """A certified exact drive at B = 4 whose full-27 loop associates
    through ``csrc/nn27.cu``: replayed (the kernel inside the fallback's
    IF bodies), eager, and eager through the plain association
    (``nn27.applies`` patched off), every frame with the same pose bits,
    fallback flags, iterations, correspondences and counts row."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import nn27

    cfg = Config(**EXACT)
    count = 20
    seqs = [_headline_drive(count, s) for s in range(4)]
    counts = _count_on_device(monkeypatch, card)
    before = nn27.LAUNCHES
    graph = _exact_frames(card, cfg, seqs, False, count, counts)
    eager = _exact_frames(card, cfg, seqs, True, count, counts)
    assert nn27.LAUNCHES > before
    monkeypatch.setattr(nn27, "applies", lambda *args: False)
    before = nn27.LAUNCHES
    plain = _exact_frames(card, cfg, seqs, True, count, counts)
    assert nn27.LAUNCHES == before
    for f, (g, e, p) in enumerate(zip(graph, eager, plain)):
        for i in (0, 1, 5, 6, 7):
            assert torch.equal(g[i], e[i]) and torch.equal(e[i], p[i]), (f, i)
        # the counts row's trips are the loop's iterations where it ran
        assert torch.equal(g[7][:, 4], torch.where(g[1], g[5], 0)), f
    assert any(g[1].any() for g in graph)  # the fallback ran


@pytest.mark.cuda
def test_float64_exact_drive_on_nn27_bit_equal_to_plain(card, monkeypatch):
    """20 headline frames through a float64 server under the certified
    exact mode: the full-27 loop associates through the kernel's float64
    instance, and every pose equals, bit for bit, the same drive through
    the plain association (``nn27.applies`` patched off)."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.ops import nn27
    from kinematic_icp_tpu_torch.server import LidarOdometryServer

    seq = _headline_drive(20)
    runs = {}
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(nn27, "applies", lambda *args: False)
        s = LidarOdometryServer(Config(**EXACT), extrinsic=seq["extrinsic"],
                                dtype=torch.float64, device=card,
                                eager=True)
        before = nn27.LAUNCHES
        for i, (p, t) in enumerate(seq["frames"]):
            s.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * i)
        assert s.state.pose.dtype == torch.float64
        runs[kernel] = (np.asarray([p for _, p in s.poses_with_stamps]),
                        nn27.LAUNCHES - before,
                        s.frame_stats["exact_fallback_frames"])
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    assert runs[True][2] == runs[False][2] > 0  # the fallback ran
    assert runs[True][1] > 0 and runs[False][1] == 0


@pytest.mark.cuda
def test_served_exact_drive_replayed_bit_equal_to_eager(card, monkeypatch):
    """20 headline frames through a blocking server under the certified
    exact mode: one graph, replays bit-equal to the eager steps, with the
    same ``check_crossing`` launches and full-27 loops, each loop on a
    frame whose flag is set."""
    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.server import LidarOdometryServer

    seq = _headline_drive(20)
    counts = _count_on_device(monkeypatch, card)
    runs = {}
    for eager in (True, False):
        s = LidarOdometryServer(Config(**EXACT), extrinsic=seq["extrinsic"],
                                device=card, eager=eager)
        s.warmup(len(seq["frames"][0][0]))
        counts.zero_()
        before = gn.CROSSING_LAUNCHES
        for i, (p, t) in enumerate(seq["frames"]):
            s.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * i)
        loops, _, crossed = counts.tolist()
        runs[eager] = (np.asarray([p for _, p in s.poses_with_stamps]),
                       gn.CROSSING_LAUNCHES - before, loops)
        assert loops == crossed
        if not eager:
            assert [c.graphs for _, c in s._calls.values()] == [1]
    np.testing.assert_array_equal(runs[False][0], runs[True][0])
    assert runs[False][1:] == runs[True][1:]
    assert runs[False][1] == 19 and runs[False][2] > 0


def _captured_motion(card, b, **kw):
    """``compute_robot_motion`` under ``MOTION`` and ``kw`` as one static
    call over buffers for a map table, sources and mask of ``_scene``'s
    shapes, guesses, taus and last poses (identity), ``b`` rows (0:
    unbatched).  Returns (call, buffers)."""
    from kinematic_icp_tpu_torch.utils.cuda_graph import StaticCall

    m, source, mask = _scene(card, seed=2)
    lead = (b,) if b else ()
    bufs = [m.table.expand(*lead, *m.table.shape).clone(),
            *(p.expand(*lead, -1).clone() for p in source),
            mask.expand(*lead, -1).clone(),
            torch.eye(4, device=card).expand(*lead, 4, 4).clone(),
            torch.eye(4, device=card).expand(*lead, 4, 4).clone(),
            torch.zeros(lead, device=card)]

    def fn(table, x, y, z, mask, last, guess, tau):
        return registration.compute_robot_motion(
            hashmap.MapState(table, m.bucket_slots), P3(x, y, z), mask, last,
            guess, tau, **{**MOTION, **kw})

    return StaticCall(fn, bufs, capture=True), bufs


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(exact_gn_reassociation=False, num_candidate_voxels=10,
         gn_backend="torch"),
    dict(gn_backend="torch")], ids=["loop", "full_27"])
def test_replayed_gn_loop_reassociates_as_jax_while_loop(card, monkeypatch,
                                                         kw):
    """A batched GN loop (B = 4) captured once and replayed over three
    sets of guesses: each replay bit-equal to the eager solve over the same
    buffers, and the associations it makes, counted on the device inside
    the conditional nodes, are 1 + the most re-associations of a row (the
    most iterations of a row), as JAX's ``while_loop`` makes them, where
    the eager solve makes 10."""
    sets = [[(1e-4, 0, 0), (0.01, 0, 0.005), (0.02, 0.01, 0.01),
             (0.01, 0, 0.005)],
            [(1e-4, 0, 0)] * 4,
            [(0.45, 0, 0), (1e-4, 0, 0), (0.02, 0.01, 0.01),
             (0.01, 0, 0.005)]]
    counts = _count_on_device(monkeypatch, card)
    call, bufs = _captured_motion(card, 4, **kw)
    bufs[-1].fill_(2.0)
    call.prepare()
    made = []
    for offsets in sets:
        bufs[-2].copy_(torch.stack([_guess(card, *o) for o in offsets]))
        counts.zero_()
        pose, debug = call()
        graph = ((_bits(pose).clone(), debug.iterations.clone(),
                  debug.num_correspondences.clone()), counts[:2].tolist())
        counts.zero_()
        pose, debug = call.fn(*bufs)
        eager = ((_bits(pose), debug.iterations, debug.num_correspondences),
                 counts[:2].tolist())
        for a, b in zip(graph[0], eager[0]):
            assert torch.equal(a, b)
        its = graph[0][1].tolist()
        assert graph[1] == [1, max(its)] and eager[1] == [1, 10]
        made.append(max(its))
    assert made[1] == 1 and made[2] == 10 and 1 < made[0] < 10


@pytest.mark.cuda
def test_certified_fallback_captured_as_nested_if_nodes(card, monkeypatch):
    """The certified solve captured once: the full-27 fallback an IF node
    on the kernel's flag, the loop's trips and re-associations IF nodes
    nested inside it.  Replayed over a frame whose certificate holds and
    one whose certificate fails, in turns, each replay is bit-equal to the
    eager solve over the same buffers; the loop runs (counted on the
    device) only where the flag is set, with 1 + (iterations - 1)
    associations, and every replay launches the ``check_crossing``
    kernel once."""
    m_hold, src_hold, mask_hold = _scene(
        card, **dict(zip(("map_pts", "src", "mask"), _margin_setup(n=512))))
    m_cross, src_cross, mask_cross = _scene(card, seed=2)
    frames = {False: (m_hold.table, *src_hold, mask_hold,
                      _guess(card, 1e-4, 0.0, 0.0), 0.7),
              True: (m_cross.table, *src_cross, mask_cross,
                     _guess(card, 0.45, 0.0, 0.0), 2.0)}
    counts = _count_on_device(monkeypatch, card)
    call, bufs = _captured_motion(card, 0, gn_backend="cuda")
    call.prepare()
    assert call.graphs == 1
    for crosses in (True, False, True, False):
        table, x, y, z, mask, guess, tau = frames[crosses]
        for buf, value in zip(bufs[:5], (table, x, y, z, mask)):
            buf.copy_(value)
        bufs[6].copy_(guess)
        bufs[7].fill_(tau)
        counts.zero_()
        before = gn.CROSSING_LAUNCHES
        pose, debug = call()
        graph = [_bits(pose).clone(), *(t.clone() for t in debug[:4])]
        loops, made, flagged = counts.tolist()
        assert gn.CROSSING_LAUNCHES == before + 1
        assert bool(graph[4]) == crosses == bool(loops) == bool(flagged)
        assert made == (int(graph[1]) if crosses else 0)
        pose, debug = call.fn(*bufs)
        for a, b in zip(graph, (_bits(pose), *debug[:4])):
            assert torch.equal(a, b)


def _count_sharded_loop(monkeypatch, dev):
    """Wrap ``registration.run_gn`` and ``sharded._all_reduce`` to count,
    in a device tensor, [associations, the most iterations of a row, the
    map-axis collectives issued while ``run_gn`` runs], summed over the
    loops.  Device ops where the work is, inside whatever conditional node
    holds it, so a replay counts what it ran."""
    from kinematic_icp_tpu_torch.parallel import sharded

    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    run_gn, all_reduce = registration.run_gn, sharded._all_reduce
    in_loop = [False]

    def counting(associate, *args, **kw):
        def counted(pose):
            counts[0].add_(1)
            return associate(pose)

        in_loop[0] = True
        try:
            out = run_gn(counted, *args, **kw)
        finally:
            in_loop[0] = False
        counts[1].add_(out[1].max().to(torch.int64))
        return out

    def counting_all_reduce(t, op, axes):
        if in_loop[0]:
            counts[2].add_(1)
        return all_reduce(t, op, axes)

    monkeypatch.setattr(registration, "run_gn", counting)
    monkeypatch.setattr(sharded, "_all_reduce", counting_all_reduce)
    return counts


#: the GN loop's collectives besides a SUM a trip and a MIN an association:
#: β's SUM before the first trip and the correspondence count's after the
#: last
AROUND_THE_LOOP = 2


@pytest.mark.cuda
def test_sharded_one_rank_nccl_captured_bit_equal_to_eager(card,
                                                           monkeypatch):
    """A one-rank NCCL group: the sharded runner's frame captured as one
    CUDA graph, bit-equal to its eager loop with the same collectives
    outside the GN loop (the insert failures' SUM: 1 a frame) and fewer
    inside it, counted on the device (eager issues every trip's: 2 x 10 +
    2 a frame)."""
    import socket

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.offline import pad_batch
    from kinematic_icp_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh, mesh as tmesh,
                                                  sharded,
                                                  shutdown_distributed)
    from kinematic_icp_tpu_torch.utils import synthetic

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True)
    seqs = [synthetic.make_sequence(5, world_seed=w, traj_seed=w + 10,
                                    noise_seed=w + 20) for w in range(2)]
    arrays = [torch.from_numpy(a).to(card) for a in pad_batch(seqs, cfg)]
    counts = _count_sharded_loop(monkeypatch, card)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(1, 1)
        # a map group of one rank reduces nothing: no peer regions
        assert tmesh.map_reduction(mesh).peers is None
        assert tmesh.map_route(mesh) == "none"
        runs = {}
        for eager in (True, False):
            run = sharded.make_sharded_sequence_runner(cfg, mesh,
                                                       eager=eager)
            before = sharded.COLLECTIVES
            counts.zero_()
            out = run(sharded.init_sharded_state(cfg, mesh, 2),
                      *arrays[:4], torch.eye(4, device=card), arrays[4])
            torch.cuda.synchronize()
            runs[eager] = out, (sharded.COLLECTIVES - before,
                                int(counts[2]))
        assert [c.graphs for c in run.step.calls] == [1]
    finally:
        shutdown_distributed()
    (want, n_want), (got, n_got) = runs[True], runs[False]
    assert n_got[0] == n_want[0] == 5
    assert n_want[1] == 5 * (2 * 10 + AROUND_THE_LOOP)
    assert 0 < n_got[1] < n_want[1]
    for a, b in zip((*got[1:], got[0].map.table),
                    (*want[1:], want[0].map.table)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_sharded_one_rank_nccl_frames_replayed_exit_early(card, monkeypatch):
    """A one-rank NCCL group: ``make_sharded_step``'s frame captured once,
    then each frame replayed under ``set_sync_debug_mode("error")``,
    bit-equal to the eager frame (``sharded_register_frame`` op by op)
    with the same iterations.  Counted on the device: the replay
    associates as JAX's ``while_loop`` (the most iterations of a row, below
    ``max_num_iterations`` on some frame) where eager associates 10 times a
    loop, and its loop issues a SUM a trip and a MIN an association
    besides β's and the correspondence count's SUMs (2 trips + 2) where
    eager issues 2 x 10 + 2."""
    import socket

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import pad_batch
    from kinematic_icp_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh, mesh as tmesh,
                                                  sharded,
                                                  shutdown_distributed)
    from kinematic_icp_tpu_torch.utils import synthetic

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True)
    frames = 6
    seqs = [synthetic.make_sequence(frames, world_seed=w, traj_seed=w + 10,
                                    noise_seed=w + 20) for w in range(2)]
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a).to(card)
                                   for a in pad_batch(seqs, cfg))
    ext = torch.eye(4, device=card)
    active = torch.ones(2, dtype=torch.bool, device=card)
    # [associations, the most iterations of a row, the loop's
    # collectives], a loop at a time
    counts = _count_sharded_loop(monkeypatch, card)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(1, 1)
        step = sharded.make_sharded_step(cfg, mesh)
        state = sharded.init_sharded_state(cfg, mesh, 2)
        eager = pipeline.clone_state(state)
        step(pipeline.clone_state(state), pts[0], ts[0], mask[0], has_ts[0],
             ext, rels[0], active)  # the capture
        assert [c.graphs for s in tmesh._captured for c in s.calls] == [1]
        trips = []
        for f in range(frames):
            inputs = (pts[f], ts[f], mask[f], has_ts[f], ext, rels[f])
            counts.zero_()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, poses, _ = step(state, *inputs, active)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            graph = (_bits(poses).clone(), counts.tolist())
            counts.zero_()
            eager, out = sharded.sharded_register_frame(
                eager, *inputs, cfg, mesh, active=active)
            its = int(out.debug.iterations.max())
            assert torch.equal(graph[0], _bits(out.pose)), f
            assert graph[1] == [its, its, 2 * its + AROUND_THE_LOOP], f
            assert counts.tolist() == [10, its,
                                       2 * 10 + AROUND_THE_LOOP], f
            trips.append(its)
    finally:
        shutdown_distributed()
    assert min(trips) < 10


@pytest.mark.cuda
def test_sharded_one_rank_forced_nccl_replayed_without_if_nodes(card,
                                                               monkeypatch):
    """A one-rank NCCL group forced onto the "nccl" route
    (``make_mesh(map_reduce="nccl")``): NCCL's ``all_reduce`` over the one
    rank, captured in the frame's one graph with no conditional node (no
    IF body), each frame replayed under ``set_sync_debug_mode("error")``
    bit-equal to the eager frame and to the "auto" route's replay (a
    one-rank group that reduces nothing, its loop exiting early).  Counted
    on the device: the "nccl" loop runs ``max_num_iterations`` trips (10
    associations) and issues 2 x 10 + 2 collectives a loop, replayed and
    eager alike, with the iterations the "auto" replay makes in its own
    trips."""
    import socket

    from kinematic_icp_tpu_torch import Config
    from kinematic_icp_tpu_torch.models import pipeline
    from kinematic_icp_tpu_torch.offline import pad_batch
    from kinematic_icp_tpu_torch.parallel import (initialize_distributed,
                                                  make_mesh, mesh as tmesh,
                                                  sharded,
                                                  shutdown_distributed)
    from kinematic_icp_tpu_torch.utils import synthetic

    cfg = Config(max_points=4096, max_downsampled=4096, max_source=1024,
                 map_capacity=1 << 13, max_range=60.0, deskew=True)
    frames, trips = 6, cfg.max_num_iterations
    seqs = [synthetic.make_sequence(frames, world_seed=w, traj_seed=w + 10,
                                    noise_seed=w + 20) for w in range(2)]
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a).to(card)
                                   for a in pad_batch(seqs, cfg))
    ext = torch.eye(4, device=card)
    active = torch.ones(2, dtype=torch.bool, device=card)
    counts = _count_sharded_loop(monkeypatch, card)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        meshes = {r: make_mesh(1, 1, map_reduce=r) for r in ("nccl", "auto")}
        assert [tmesh.map_route(m) for m in meshes.values()] == ["nccl",
                                                                 "none"]
        assert tmesh._peers == []
        steps, states, calls = {}, {}, {}
        for r, m in meshes.items():
            before = set(tmesh._captured)
            steps[r] = sharded.make_sharded_step(cfg, m)
            states[r] = sharded.init_sharded_state(cfg, m, 2)
            steps[r](pipeline.clone_state(states[r]), pts[0], ts[0], mask[0],
                     has_ts[0], ext, rels[0], active)  # the capture
            calls[r] = [c for s in set(tmesh._captured) - before
                        for c in s.calls]
        assert [c.graphs for c in calls["nccl"] + calls["auto"]] == [1, 1]
        assert calls["nccl"][0].body_pools == []  # no IF node
        assert calls["auto"][0].body_pools != []
        eager = pipeline.clone_state(states["nccl"])
        its_seen = []
        for f in range(frames):
            inputs = (pts[f], ts[f], mask[f], has_ts[f], ext, rels[f])
            got = {}
            for r, step in steps.items():
                counts.zero_()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    states[r], poses, _ = step(states[r], *inputs, active)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                got[r] = (_bits(poses).clone(), counts.tolist())
            counts.zero_()
            eager, out = sharded.sharded_register_frame(
                eager, *inputs, cfg, meshes["nccl"], active=active)
            its = int(out.debug.iterations.max())
            assert torch.equal(got["nccl"][0], _bits(out.pose)), f
            assert torch.equal(got["auto"][0], got["nccl"][0]), f
            every = [trips, its, 2 * trips + AROUND_THE_LOOP]
            assert got["nccl"][1] == counts.tolist() == every, f
            assert got["auto"][1] == [its, its, 2 * its + AROUND_THE_LOOP], f
            its_seen.append(its)
    finally:
        shutdown_distributed()
    assert min(its_seen) < trips


#: the map axis's reductions (dtype, op, elements) at the sharded path's
#: shapes (B = 2): β's sums, the normal equations, the packed keys of 1,024
#: queries a row, the correspondence count; and a float64 state's sums
PEER_REDUCTIONS = [("float32", "SUM", 4), ("float32", "SUM", 12),
                   ("int32", "MIN", 2048), ("int32", "SUM", 2),
                   ("float64", "SUM", 12)]


def _peer_parts(card, rng, size, dtype, n):
    if dtype == "int32":
        return [torch.from_numpy(rng.integers(-2**30, 2**30, n,
                                              dtype=np.int32)).to(card)
                for _ in range(size)]
    return [torch.from_numpy(rng.normal(0, 100.0, n).astype(dtype)).to(card)
            for _ in range(size)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 2, 4])
def test_peer_all_reduce_matches_its_plain_version(card, size):
    """``size`` ranks of a peer group on one card, each launching the
    kernel on a stream of its own at once, over five rounds of the map
    axis's reductions (both slots, every kind): every rank's result is the
    plain version's (rank-order sums and minima) bit for bit."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import peer

    groups = peer.local_groups(card, size)
    streams = [torch.cuda.Stream(card) for _ in range(size)]
    rng = np.random.default_rng(size)
    try:
        for _ in range(5):
            for dtype, op, n in PEER_REDUCTIONS:
                op = getattr(dist.ReduceOp, op)
                parts = _peer_parts(card, rng, size, dtype, n)
                want = peer.reference(parts, op)
                got = [p.clone() for p in parts]
                torch.cuda.synchronize()
                for g, s, t in zip(groups, streams, got):
                    with torch.cuda.stream(s):
                        g.all_reduce(t, op)
                torch.cuda.synchronize()
                for t in got:
                    assert torch.equal(_bits(t), _bits(want)), (dtype, n)
    finally:
        for g in groups:
            g.free()


#: every kind of the peer kernel: (dtype, op)
PEER_KINDS = [("float32", "SUM"), ("float64", "SUM"), ("int32", "SUM"),
              ("int32", "MIN")]


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [2.5, 3.01],
                         ids=["2.5-slots", "3-slots-and-a-remainder"])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_peer_all_reduce_beyond_a_slot(card, size, slots):
    """``size`` ranks of a peer group on one card reduce more than a slot
    (``peer.SLOT_BYTES``) of every kind, a launch a slot, each rank on a
    stream of its own at once: eagerly, then as each rank's captured graph
    replayed twice, then eagerly again (the launches' epochs read and
    bumped on the device, so replays and eager launches interleave), every
    rank's result the plain version's bits each time, and one count in
    ``peer.LAUNCHES`` a launch issued or captured."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import peer

    groups = peer.local_groups(card, size)
    streams = [torch.cuda.Stream(card) for _ in range(size)]
    rng = np.random.default_rng([size, int(slots * 100)])
    try:
        for dtype, op in PEER_KINDS:
            op = getattr(dist.ReduceOp, op)
            n = int(slots * peer.SLOT_BYTES) // np.dtype(dtype).itemsize
            assert len(peer.chunks(n, np.dtype(dtype).itemsize)) == int(
                np.ceil(slots))
            parts = _peer_parts(card, rng, size, dtype, n)
            want = _bits(peer.reference(parts, op))
            data = [p.clone() for p in parts]
            torch.cuda.synchronize()
            before = peer.LAUNCHES
            for g, s, t in zip(groups, streams, data):
                with torch.cuda.stream(s):
                    g.all_reduce(t, op)
            torch.cuda.synchronize()
            assert peer.LAUNCHES - before == size * int(np.ceil(slots))
            assert all(torch.equal(_bits(t), want) for t in data), dtype
            graphs = []
            for g, s, t in zip(groups, streams, data):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(s):
                    graph.capture_begin()
                    try:
                        g.all_reduce(t, op)
                    finally:
                        graph.capture_end()
                graphs.append(graph)
            for replay in range(2):
                for t, p in zip(data, parts):
                    t.copy_(p)
                torch.cuda.synchronize()
                for graph, s in zip(graphs, streams):
                    with torch.cuda.stream(s):
                        graph.replay()
                torch.cuda.synchronize()
                assert all(torch.equal(_bits(t), want) for t in data), (
                    dtype, replay)
            for t, p in zip(data, parts):
                t.copy_(p)
            torch.cuda.synchronize()
            for g, s, t in zip(groups, streams, data):
                with torch.cuda.stream(s):
                    g.all_reduce(t, op)
            torch.cuda.synchronize()
            assert all(torch.equal(_bits(t), want) for t in data), (
                dtype, "eager after the replays")
    finally:
        torch.cuda.synchronize()
        for g in groups:
            g.free()


@pytest.mark.cuda
def test_peer_all_reduce_runs_inside_a_captured_if_node(card):
    """Two ranks of a peer group on one card, each with its own graph
    holding the reduction inside an IF node (``cuda_graph.when``), the two
    replayed at once on two streams: the sums where the predicate is set,
    the data untouched where it is clear, over alternating replays."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import peer
    from kinematic_icp_tpu_torch.utils import cuda_graph

    card = torch.device("cuda", torch.cuda.current_device())
    groups = peer.local_groups(card, 2)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    data = [torch.zeros(12, device=card) for _ in range(2)]
    pred = torch.zeros((), dtype=torch.bool, device=card)
    graphs = []
    before = cuda_graph.IF_LAUNCHES
    try:
        for g, s, t in zip(groups, streams, data):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(s):
                graph.capture_begin()
                capture = cuda_graph._active = cuda_graph._Capture(card)
                try:
                    cuda_graph.when(pred, functools.partial(
                        g.all_reduce, t, dist.ReduceOp.SUM))
                finally:
                    cuda_graph._active = None
                    graph.capture_end()
                    capture.close()
            graphs.append(graph)
        # one IF node a graph, its handle set by one captured launch
        assert cuda_graph.IF_LAUNCHES - before == 2
        for k in range(6):
            for r, t in enumerate(data):
                t.fill_(r + 1.0 + k)
            pred.fill_(k % 2 == 1)
            torch.cuda.synchronize()
            for graph, s in zip(graphs, streams):
                with torch.cuda.stream(s):
                    graph.replay()
            torch.cuda.synchronize()
            for r, t in enumerate(data):
                want = 3.0 + 2 * k if k % 2 else r + 1.0 + k
                assert t.tolist() == [want] * 12, k
    finally:
        for g in groups:
            g.free()


def _edge_sizes(itemsize):
    """Element counts at the kernel's edges for ``itemsize``-byte elements:
    none, one, three, a 16-byte vector's width and one either side, a tile
    and one more, a slot and one more, and beyond a slot."""
    from kinematic_icp_tpu_torch.parallel import peer

    width = 16 // itemsize
    tile, slot = peer.TILE_BYTES // itemsize, peer.SLOT_BYTES // itemsize
    return sorted({0, 1, 3, width - 1, width, width + 1, tile, tile + 1,
                   slot, slot + 1, 2 * slot + tile + 3})


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["one_shot", "two_shot"])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_peer_all_reduce_at_the_edge_sizes(card, monkeypatch, size,
                                           algorithm):
    """``size`` ranks of a peer group on one card, every kind, at every
    edge size (``_edge_sizes``: the scalar tail, a partial tile, a full
    slot, a slot and one more, beyond), by each algorithm forced on every
    launch, and on a tensor that starts one element past a 16-byte
    boundary (the element-by-element path): every rank's result the
    plain version's bits."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import peer

    monkeypatch.setattr(peer, "algorithm", lambda nbytes, m: algorithm)
    groups = peer.local_groups(card, size)
    streams = [torch.cuda.Stream(card) for _ in range(size)]
    rng = np.random.default_rng([size, len(algorithm)])
    try:
        for dtype, op in PEER_KINDS:
            op = getattr(dist.ReduceOp, op)
            itemsize = np.dtype(dtype).itemsize
            for n in _edge_sizes(itemsize) + ["offset"]:
                if n == "offset":  # a view one element into its storage
                    parts = [p[1:] for p in _peer_parts(card, rng, size,
                                                        dtype, 1001)]
                    assert parts[0].data_ptr() % 16
                else:
                    parts = _peer_parts(card, rng, size, dtype, n)
                want = peer.reference(parts, op)
                got = [p.clone() if n != "offset" else p for p in parts]
                torch.cuda.synchronize()
                before = peer.LAUNCHES
                for g, s, t in zip(groups, streams, got):
                    with torch.cuda.stream(s):
                        g.all_reduce(t, op)
                torch.cuda.synchronize()
                if n == 0:  # nothing to reduce: no launch
                    assert peer.LAUNCHES == before
                    assert all(t.numel() == 0 for t in got)
                    continue
                for t in got:
                    assert torch.equal(_bits(t), _bits(want)), (dtype, n)
    finally:
        torch.cuda.synchronize()
        for g in groups:
            g.free()


@pytest.mark.cuda
def test_four_ranks_on_one_card_at_the_largest_grid_finish(card,
                                                           monkeypatch):
    """Four ranks of a peer group on one card, each with the grid that
    shares the card four ways (``peer.grid``: every CTA of the four
    resident at once), reduce full slots (every CTA of the grid runs) by
    both algorithms, twenty rounds: every round finishes, with the plain
    version's bits (a CTA that could not be scheduled would leave its
    peers spinning until the barrier's trap)."""
    import torch.distributed as dist

    from kinematic_icp_tpu_torch.parallel import peer

    capacity = peer.capacity(card)
    groups = peer.local_groups(card, 4)
    largest = peer.grid(capacity, 4)
    assert all(g.grid == largest for g in groups)
    assert 4 * largest <= capacity and largest > 1
    n = peer.SLOT_BYTES // 4
    assert peer.ctas(n, 4, largest) == largest
    streams = [torch.cuda.Stream(card) for _ in range(4)]
    rng = np.random.default_rng(4)
    try:
        for k in range(20):
            monkeypatch.setattr(peer, "algorithm", lambda nbytes, m: (
                "one_shot", "two_shot")[k % 2])
            parts = _peer_parts(card, rng, 4, "int32", n)
            want = _bits(peer.reference(parts, dist.ReduceOp.MIN))
            got = [p.clone() for p in parts]
            torch.cuda.synchronize()
            for g, s, t in zip(groups, streams, got):
                with torch.cuda.stream(s):
                    g.all_reduce(t, dist.ReduceOp.MIN)
            torch.cuda.synchronize()
            assert all(torch.equal(_bits(t), want) for t in got), k
    finally:
        torch.cuda.synchronize()
        for g in groups:
            g.free()


#: one rank of ``test_peer_group_attached_across_two_processes``: ARGV
#: rank, port, the reductions as JSON
_PEER_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from kinematic_icp_tpu_torch.parallel import peer

rank, port, reductions = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
torch.cuda.set_device(0)
dev = torch.device("cuda", 0)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
mine = peer.attach(dist.group.WORLD, dev)
bad = []
try:
    for k, (dtype, op, n) in enumerate(reductions):
        op = getattr(dist.ReduceOp, op)
        for r in range(3):
            rng = np.random.default_rng([k, r])  # the same on both ranks
            if dtype == "int32":
                parts = [rng.integers(-2**30, 2**30, n, dtype=np.int32)
                         for _ in range(2)]
            else:
                parts = [rng.normal(0, 100.0, n).astype(dtype)
                         for _ in range(2)]
            parts = [torch.from_numpy(p).to(dev) for p in parts]
            got = parts[rank].clone()
            mine.all_reduce(got, op)
            torch.cuda.synchronize()
            want = peer.reference(parts, op)
            if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
                bad.append([dtype, n, r])
finally:
    torch.cuda.synchronize()
    dist.barrier()
    mine.close()
    dist.barrier()
    mine.free()
    dist.destroy_process_group()
print(f"rank {rank}: " + ("OK" if not bad else json.dumps(bad)), flush=True)
'''


@pytest.mark.cuda
def test_peer_group_attached_across_two_processes(card):
    """Two processes on one card, a gloo group between them:
    ``peer.attach`` checks both ranks' reach, exchanges the IPC handles
    and maps each other's region; three rounds of every reduction the
    sharded path makes (``PEER_REDUCTIONS``) give both ranks the plain
    version's bits; then both unmap before either frees, as
    ``parallel.shutdown_distributed`` does, and both exit cleanly."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PEER_WORKER, str(r), str(port),
         json.dumps(PEER_REDUCTIONS)], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r}: OK" in log, log[-3000:]
