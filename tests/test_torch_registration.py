"""Port vs JAX: the registration branches and the hashmap functions they use.

Same seed-made inputs through both packages on the CPU.  Integer outputs
(skip bounds, native neighbours, reduced words, the point cloud,
iterations, correspondences, ``exact_fallback``) are bit-equal; poses agree
within 1e-6 (same per-element rounding, sums in another order).  Within the
port, pruned-exact equals the full-27 loop bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu.ops import hashmap as jhm
from kinematic_icp_tpu.ops import pallas_gn
from kinematic_icp_tpu.ops import registration as jreg
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu.ops.points import transform as jtransform
from kinematic_icp_tpu_torch.ops import gn
from kinematic_icp_tpu_torch.ops import hashmap as thm
from kinematic_icp_tpu_torch.ops import registration as treg
from kinematic_icp_tpu_torch.ops.points import P3 as TP3

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

CAP, K, G = 1 << 12, 20, 4
MOTION = dict(voxel_size=1.0, max_probes=G, max_num_iterations=10,
              convergence_criterion=0.001,
              use_adaptive_odometry_regularization=True,
              fixed_regularization=0.0, num_candidate_voxels=27,
              threshold_max_range=60.0)


def _planes(a):
    return (JP3.from_array(jnp.asarray(a)), TP3.from_array(torch.from_numpy(a)))


def _maps(map_pts, cap=CAP):
    """The port's insert of ``map_pts``, and the same table as a JAX map
    (inserts are bit-equal, tests/test_torch_hashmap.py)."""
    tm = thm.empty(cap, K, bucket_slots=G)
    if len(map_pts):
        tm = thm.insert(tm, TP3.from_array(torch.from_numpy(map_pts)),
                        torch.ones(len(map_pts), dtype=torch.bool), 1.0, G,
                        max_extent=120.0)
    jm = jhm.MapState(table=jnp.asarray(tm.table.numpy().view(np.uint32)),
                      bucket_slots=G)
    return jm, tm


def _walls(rng, n):
    """Points on the walls of a 40 m room (tests/test_registration.py)."""
    wall = rng.integers(0, 4, n)
    s = rng.uniform(-20, 20, n)
    z = rng.uniform(0.0, 3.0, n)
    side = np.where(wall % 2 == 0, -20.0, 20.0)
    x = np.where(wall < 2, s, side)
    y = np.where(wall < 2, side, s)
    return np.stack([x, y, z], 1).astype(np.float32)


def _cloud(seed, n=512, nmap=2000):
    """A walls map, its noisy points as sources, 95 % of them valid."""
    rng = np.random.default_rng(seed)
    world = _walls(rng, nmap)
    src = (world[:n] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    return world, src, rng.uniform(size=n) < 0.95


def _margin_setup(n=400):
    """tests/test_pallas_gn.py:_margin_setup: points >= 0.21 from every
    voxel boundary, so small GN steps never change a query's voxel."""
    rng = np.random.default_rng(1234)
    base = rng.integers(-15, 15, (1200, 3)).astype(np.float32)
    frac = rng.uniform(0.21, 0.79, (1200, 3)).astype(np.float32)
    map_pts = np.unique(base + frac, axis=0)
    src = map_pts[:n] + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    src = np.clip(src - np.floor(src), 0.21, 0.79) + np.floor(src)
    return map_pts, src.astype(np.float32), np.ones(n, bool)


def _crossing_setup(n=512, nmap=3000):
    """tests/test_pallas_gn.py:setup: a uniform cloud; with a 0.45 m guess
    offset and tau 2.0 the GN steps carry points across voxels."""
    rng = np.random.default_rng(0)
    map_pts = rng.uniform(-20, 20, (nmap, 3)).astype(np.float32)
    src = (map_pts[:n] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    return map_pts, src, rng.uniform(size=n) < 0.9


def _guess(tx, ty=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_solver(static):
    """JAX's compute_robot_motion jitted once per set of static arguments
    (eager calls re-trace its loops every time)."""
    kw = dict(static)
    return jax.jit(lambda m, src, mask, guess, tau: jreg.compute_robot_motion(
        m, src, mask, jnp.eye(4, dtype=jnp.float32), guess, tau, **kw))


def _jax_motion(jm, src, mask, guess, tau, **kw):
    solve = _jax_solver(tuple(sorted({**MOTION, "gn_backend": "xla",
                                      **kw}.items())))
    return solve(jm, JP3.from_array(jnp.asarray(src)), jnp.asarray(mask),
                 jnp.asarray(guess), jnp.float32(tau))


def _port_motion(tm, src, mask, guess, tau, **kw):
    return treg.compute_robot_motion(
        tm, TP3.from_array(torch.from_numpy(src)), torch.from_numpy(mask),
        torch.eye(4), torch.from_numpy(guess),
        torch.tensor(tau, dtype=torch.float32),
        **{**MOTION, "gn_backend": "torch", **kw})


def _assert_close(tout, jout):
    tpose, tdbg = tout
    jpose, jdbg = jout
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-6,
                               rtol=0)
    assert int(tdbg.iterations) == int(jdbg.iterations)
    assert int(tdbg.num_correspondences) == int(jdbg.num_correspondences)


def _assert_bit_equal(a, b):
    assert torch.equal(a[0], b[0])
    assert int(a[1].iterations) == int(b[1].iterations)
    assert int(a[1].num_correspondences) == int(b[1].num_correspondences)


class TestHashmap:
    @pytest.fixture(scope="class")
    def scene(self):
        rng = np.random.default_rng(5)
        pts = rng.uniform(-15, 15, (3000, 3)).astype(np.float32)
        jm, tm = _maps(pts)
        q = (pts[:700] + rng.normal(0, 0.3, (700, 3))).astype(np.float32)
        q[600:] = rng.uniform(-40, 40, (100, 3))  # some with no neighbours
        return jm, tm, q, rng.uniform(size=700) < 0.9

    @pytest.mark.parametrize("v", [8, 14, 22, 27])
    def test_gather_skip_bound_bit_equal(self, scene, v):
        jm, tm, q, _ = scene
        jq, tq = _planes(q)
        jc, jlb = jhm.gather_candidates(jm, jq, 1.0, G, v,
                                        return_skip_bound=True)
        tc, tlb = thm.gather_candidates(tm, tq, 1.0, G, v,
                                        return_skip_bound=True)
        np.testing.assert_array_equal(tlb.numpy().view(np.uint32),
                                      np.asarray(jlb).view(np.uint32))
        np.testing.assert_array_equal(tc.words.numpy().view(np.uint32),
                                      np.asarray(jc.words))
        np.testing.assert_array_equal(tc.rel.numpy(), np.asarray(jc.rel))
        if v < 27:
            assert np.isfinite(np.asarray(jlb)).all()
        else:
            assert np.isinf(np.asarray(jlb)).all()

    @pytest.mark.parametrize("v", [10, 27])
    def test_nearest_neighbor_bit_equal(self, scene, v):
        """V = 27 is JAX's ``nearest_neighbor_native``, the port's full
        gather and re-selection; V = 10 the pruned gather."""
        jm, tm, q, qmask = scene
        jq, tq = _planes(q)
        jn, jd = jhm.nearest_neighbor(jm, jq, jnp.asarray(qmask), 1.0, G, v)
        tn, td = thm.nearest_neighbor(tm, tq, torch.from_numpy(qmask), 1.0,
                                      G, v)
        for a, b in zip(tn, jn):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the distance is recomputed in float32, where XLA may fuse a
        # multiply-add: 1 ulp
        jd = np.asarray(jd)
        np.testing.assert_array_equal(np.isinf(td.numpy()), np.isinf(jd))
        np.testing.assert_allclose(td.numpy(), jd, rtol=2.4e-7, atol=0)
        assert np.isinf(jd).any() and np.isfinite(jd).any()

    @pytest.mark.parametrize("keep", [4, 8, 20])
    def test_reduce_candidates_bit_equal(self, scene, keep):
        jm, tm, q, _ = scene
        jq, tq = _planes(q)
        jc = jhm.reduce_candidates(jhm.gather_candidates(jm, jq, 1.0, G, 10),
                                   jq, keep, 1.0)
        tc = thm.reduce_candidates(thm.gather_candidates(tm, tq, 1.0, G, 10),
                                   tq, keep, 1.0)
        assert tc.words.shape == (10, min(keep, K), len(q))
        np.testing.assert_array_equal(tc.words.numpy().view(np.uint32),
                                      np.asarray(jc.words))

    def test_pointcloud_bit_equal(self, scene):
        jm, tm, _, _ = scene
        (jp, jmask), (tp, tmask) = jhm.pointcloud(jm, 1.0), \
            thm.pointcloud(tm, 1.0)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert 0 < int(tmask.sum()) <= 3000


class TestLoops:
    @pytest.fixture(scope="class")
    def walls(self):
        world, src, mask = _cloud(7)
        return _maps(world), src, mask

    @pytest.mark.parametrize("tau", [0.3, 1.5])
    def test_full_27_loop_matches_jax(self, walls, tau):
        (jm, tm), src, mask = walls
        guess = _guess(0.08, 0.02, 0.01)
        kw = dict(exact_gn_reassociation=True)
        tout = _port_motion(tm, src, mask, guess, tau, **kw)
        _assert_close(tout, _jax_motion(jm, src, mask, guess, tau, **kw))
        assert tout[1].odometry_error_pt is None
        assert tout[1].exact_fallback is None
        assert int(tout[1].num_correspondences) > 100

    @pytest.mark.parametrize("v", [8, 14, 22])
    def test_pruned_exact(self, walls, v):
        (jm, tm), src, mask = walls
        guess = _guess(0.08)
        kw = dict(exact_gn_reassociation=True, exact_prune_candidates=v)
        for tau in (0.3, 1.5):
            tout = _port_motion(tm, src, mask, guess, tau, **kw)
            jout = _jax_motion(jm, src, mask, guess, tau, **kw)
            _assert_close(tout, jout)
            assert bool(tout[1].exact_fallback) == bool(
                jout[1].exact_fallback)
            _assert_bit_equal(tout, _port_motion(
                tm, src, mask, guess, tau, exact_gn_reassociation=True))

    def test_pruned_corner_voxel_forces_fallback(self):
        """tests/test_registration.py:207-235: the only map point lies in
        a corner voxel, which V=14 skips; the certificate must fire."""
        jm, tm = _maps(np.array([[-0.01, -0.01, -0.01]], np.float32))
        src = np.array([[0.5, 0.5, 0.5]], np.float32)
        mask = np.ones(1, bool)
        guess = np.eye(4, dtype=np.float32)
        kw = dict(exact_gn_reassociation=True, exact_prune_candidates=14)
        pruned = _port_motion(tm, src, mask, guess, 1.0, **kw)
        assert bool(pruned[1].exact_fallback)
        assert int(pruned[1].num_correspondences) == 1
        _assert_bit_equal(pruned, _port_motion(
            tm, src, mask, guess, 1.0, exact_gn_reassociation=True))
        jout = _jax_motion(jm, src, mask, guess, 1.0, **kw)
        _assert_close(pruned, jout)
        assert bool(jout[1].exact_fallback)

    def test_pruned_empty_map(self):
        jm, tm = _maps(np.zeros((0, 3), np.float32))
        src = np.random.default_rng(0).uniform(-5, 5, (64, 3)).astype(
            np.float32)
        mask = np.ones(64, bool)
        guess = _guess(0.0, 0.2)
        kw = dict(exact_gn_reassociation=True, exact_prune_candidates=14)
        pruned = _port_motion(tm, src, mask, guess, 0.7, **kw)
        _assert_bit_equal(pruned, _port_motion(
            tm, src, mask, guess, 0.7, exact_gn_reassociation=True))
        np.testing.assert_array_equal(pruned[0].numpy(), guess)
        jout = _jax_motion(jm, src, mask, guess, 0.7, **kw)
        _assert_close(pruned, jout)
        assert bool(pruned[1].exact_fallback) == bool(jout[1].exact_fallback)

    def test_candidates_per_voxel_matches_jax(self, walls):
        (jm, tm), src, mask = walls
        guess = _guess(0.05, -0.02, 0.01)
        kw = dict(num_candidate_voxels=10, gn_candidates_per_voxel=8)
        _assert_close(_port_motion(tm, src, mask, guess, 0.5, **kw),
                      _jax_motion(jm, src, mask, guess, 0.5, **kw))

    def test_default_loop_matches_jax(self, walls):
        (jm, tm), src, mask = walls
        guess = _guess(0.05, -0.02, 0.01)
        kw = dict(num_candidate_voxels=10)
        _assert_close(_port_motion(tm, src, mask, guess, 0.5, **kw),
                      _jax_motion(jm, src, mask, guess, 0.5, **kw))


class TestCertified:
    """``gn_backend="cuda"`` on CPU tensors: the kernel's plain version
    with the certificate, and the full-27 loop where it fails, against the
    same composition in JAX (the Pallas kernel in interpret mode, then the
    "xla" exact loop where ``crossed`` is set)."""

    @pytest.mark.parametrize("setup,tx,tau,crosses", [
        (_margin_setup, 1e-4, 0.7, False),
        (_crossing_setup, 0.45, 2.0, True),
    ], ids=["certificate-holds", "certificate-fails"])
    def test_certified_matches_jax(self, setup, tx, tau, crosses):
        map_pts, src, mask = setup()
        jm, tm = _maps(map_pts, cap=1 << 13)
        guess = _guess(tx)
        jsrc = JP3.from_array(jnp.asarray(src))
        jcand = jhm.gather_candidates(jm, jtransform(jnp.asarray(guess), jsrc),
                                      1.0, G, 27)
        k_pose, k_it, k_nc, k_err, crossed = pallas_gn.gn_solve(
            jcand, jsrc, jnp.asarray(mask), jnp.asarray(guess),
            jnp.float32(tau), voxel_size=1.0, max_num_iterations=10,
            convergence_criterion=0.001, use_adaptive_regularization=True,
            fixed_regularization=0.0, max_range=60.0, check_crossing=True,
            interpret=True)
        assert bool(crossed) == crosses
        if crosses:
            jpose, jdbg = _jax_motion(jm, src, mask, guess, tau,
                                      exact_gn_reassociation=True)
            jit, jnc = jdbg.iterations, jdbg.num_correspondences
        else:
            jpose, jit, jnc = k_pose, k_it, k_nc

        before = gn.LAUNCHES
        tpose, tdbg = _port_motion(tm, src, mask, guess, tau,
                                   exact_gn_reassociation=True,
                                   gn_backend="cuda")
        assert gn.LAUNCHES == before  # CPU tensors: the plain version
        assert bool(tdbg.exact_fallback) == crosses
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose),
                                   atol=1e-6, rtol=0)
        assert int(tdbg.iterations) == int(jit)
        assert int(tdbg.num_correspondences) == int(jnc)
        if not crosses:
            np.testing.assert_allclose(
                float(tdbg.odometry_error_pt), float(k_err), rtol=0,
                atol=1e-5 + gn.error_tolerance(k_pose, guess, 60.0, 1.5e-6))
        else:
            # the fallback's error is the kernel's formula on the loop pose
            jp = np.asarray(jpose, np.float64)
            dt = np.linalg.norm(jp[:3, 3] - guess[:3, 3])
            c = np.clip((np.sum(jp[:3, :3] * guess[:3, :3]) - 1) / 2, -1, 1)
            ref = dt + 120.0 * np.sqrt(max((1 - c) / 2, 0.0))
            np.testing.assert_allclose(float(tdbg.odometry_error_pt), ref,
                                       rtol=0,
                                       atol=1e-5 + gn.error_tolerance(
                                           jpose, guess, 60.0, 1.5e-6))

    def test_certified_fallback_equals_full_loop(self):
        map_pts, src, mask = _crossing_setup()
        _, tm = _maps(map_pts, cap=1 << 13)
        guess = _guess(0.45)
        kw = dict(exact_gn_reassociation=True)
        cert = _port_motion(tm, src, mask, guess, 2.0, gn_backend="cuda",
                            **kw)
        assert bool(cert[1].exact_fallback)
        _assert_bit_equal(cert, _port_motion(tm, src, mask, guess, 2.0, **kw))


def test_auto_backend_resolves_to_loop_on_cpu():
    world, src, mask = _cloud(3, n=128, nmap=500)
    _, tm = _maps(world)
    guess = _guess(0.05)
    kw = dict(exact_gn_reassociation=True)
    auto = _port_motion(tm, src, mask, guess, 0.7, gn_backend="auto", **kw)
    assert auto[1].exact_fallback is None  # the loop, not the kernel branch
    _assert_bit_equal(auto, _port_motion(tm, src, mask, guess, 0.7, **kw))
    with pytest.raises(ValueError):
        _port_motion(tm, src, mask, guess, 0.7, gn_backend="xla")
