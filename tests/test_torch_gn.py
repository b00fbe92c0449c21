"""Port vs JAX: the GN solve's plain version against the Pallas kernel.

The Pallas kernel runs in interpret mode, as ``tests/test_pallas_gn.py``
runs it on the CPU.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu.ops import hashmap as jhm
from kinematic_icp_tpu.ops import pallas_gn
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu.ops.points import transform as jtransform
from kinematic_icp_tpu_torch.ops import gn
from kinematic_icp_tpu_torch.ops import hashmap as thm
from kinematic_icp_tpu_torch.ops.points import P3 as TP3
from kinematic_icp_tpu_torch.ops.points import transform as ttransform

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

SOLVE = dict(voxel_size=1.0, max_num_iterations=10,
             convergence_criterion=0.001, use_adaptive_regularization=True,
             fixed_regularization=0.0, max_range=60.0)


def _maps(map_pts, k=20):
    n = len(map_pts)
    if n == 0:
        return jhm.empty(1 << 13, k), thm.empty(1 << 13, k)
    jm = jhm.insert(jhm.empty(1 << 13, k), JP3.from_array(
        jnp.asarray(map_pts)), jnp.ones(n, bool), 1.0, 4)
    tm = thm.insert(thm.empty(1 << 13, k), TP3.from_array(
        torch.from_numpy(map_pts)), torch.ones(n, dtype=torch.bool), 1.0, 4)
    return jm, tm


def setup_cloud(rng, n=512, nmap=3000, extent=20.0):
    """tests/test_pallas_gn.py:setup: noisy map points as sources."""
    map_pts = rng.uniform(-extent, extent, (nmap, 3)).astype(np.float32)
    src = (map_pts[:n] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    return map_pts, src, mask


def setup_margin(n=400):
    """tests/test_pallas_gn.py:_margin_setup: points >= 0.21 from every
    voxel boundary, so small GN steps never change a query's voxel."""
    rng = np.random.default_rng(1234)
    base = rng.integers(-15, 15, (1200, 3)).astype(np.float32)
    frac = rng.uniform(0.21, 0.79, (1200, 3)).astype(np.float32)
    map_pts = np.unique(base + frac, axis=0)
    src = map_pts[:n] + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    src = np.clip(src - np.floor(src), 0.21, 0.79) + np.floor(src)
    return map_pts, src.astype(np.float32), np.ones(n, bool)


def _guess(tx, ty=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)


def _solve_both(map_pts, src, mask, guess, tau, v, k=20, **kw):
    kw = {**SOLVE, **kw}
    jm, tm = _maps(map_pts, k)
    jsrc, tsrc = JP3.from_array(jnp.asarray(src)), TP3.from_array(
        torch.from_numpy(src))
    jg, tg = jnp.asarray(guess), torch.from_numpy(guess)
    jc = jhm.gather_candidates(jm, jtransform(jg, jsrc), 1.0, 4, v)
    tc = thm.gather_candidates(tm, ttransform(tg, tsrc), 1.0, 4, v)
    ref = pallas_gn.gn_solve(jc, jsrc, jnp.asarray(mask), jg, tau,
                             interpret=True, **kw)
    before = gn.LAUNCHES
    out = gn.gn_solve(tc, tsrc, torch.from_numpy(mask), tg, tau, **kw)
    assert gn.LAUNCHES == before  # CPU tensors take the plain version
    return out, ref


def err_tolerance(pose, guess, max_range, pose_diff=0.0):
    """Float32 tolerance of the point-space error 2 R sqrt(h) + |dt|,
    h = (1 - c)/2, c = (trace(Rg^T R) - 1)/2.

    The nine-product trace rounds to ~5e-7 in float32 (XLA may fuse
    multiply-adds, the port does not), plus 3 * |pose difference|; h then
    moves by a quarter of that, and sqrt turns it into R dh / sqrt(h) —
    near a zero rotation error a 1-ulp trace difference alone moves the
    error by ~1e-3 at R = 60 m.
    """
    frob = float(np.sum(np.asarray(pose, np.float64)[:3, :3]
                        * np.asarray(guess, np.float64)[:3, :3]))
    h = max((1.0 - (frob - 1.0) * 0.5) * 0.5, 0.0)
    dh = (5e-7 + 3.0 * pose_diff) / 4.0
    dsqrt = min(dh / max(np.sqrt(h), 1e-30), np.sqrt(dh))
    return 1e-5 + 2.0 * max_range * dsqrt + 3.0 * pose_diff


def _assert_match(out, ref, guess, max_range):
    pose, iters, ncorr, err, crossed = out
    # same per-element rounding; the sums run in another order
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref[0]), atol=1e-6,
                               rtol=0)
    assert int(iters) == int(ref[1])
    assert int(ncorr) == int(ref[2])
    np.testing.assert_allclose(
        float(err), float(ref[3]), rtol=0,
        atol=err_tolerance(ref[0], guess, max_range, pose_diff=1e-6))
    assert bool(crossed) == bool(ref[4])


class TestPlainVersionMatchesPallas:
    def test_adaptive(self):
        map_pts, src, mask = setup_cloud(np.random.default_rng(0))
        guess = _guess(0.02, -0.01, 0.01)
        out, ref = _solve_both(map_pts, src, mask, guess, 0.5, 10)
        _assert_match(out, ref, guess, 60.0)
        assert int(out[2]) > 100 and int(out[1]) > 1

    def test_fixed_regularization_empty_map(self):
        rng = np.random.default_rng(1)
        src = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
        out, ref = _solve_both(np.zeros((0, 3), np.float32), src,
                               np.ones(256, bool), _guess(0.5), 0.5, 10,
                               use_adaptive_regularization=False,
                               fixed_regularization=0.1, max_range=0.0)
        _assert_match(out, ref, _guess(0.5), 0.0)
        # empty map: no correspondences, the guess comes back unchanged
        np.testing.assert_array_equal(out[0].numpy(), _guess(0.5))
        assert int(out[1]) == 1 and int(out[2]) == 0 and float(out[3]) == 0.0

    def test_check_crossing_holds(self):
        map_pts, src, mask = setup_margin()
        out, ref = _solve_both(map_pts, src, mask, _guess(1e-4), 0.7, 27,
                               check_crossing=True)
        _assert_match(out, ref, _guess(1e-4), 60.0)
        assert not bool(out[4])

    def test_check_crossing_detected(self):
        map_pts, src, mask = setup_cloud(np.random.default_rng(2))
        out, ref = _solve_both(map_pts, src, mask, _guess(0.45), 2.0, 27,
                               check_crossing=True)
        _assert_match(out, ref, _guess(0.45), 60.0)
        assert bool(out[4])


    # The edges the kernel's 32-query tiles and row slices must get right:
    # ragged N (one query, a partial last tile, many tiles), a single
    # candidate voxel, 32 entries per voxel (the 5-bit lane field full) on a
    # dense map, and no iteration (one selection pass).
    @pytest.mark.parametrize("n,v,k,max_it,extent", [
        (1, 10, 20, 10, 20.0),
        (33, 10, 20, 10, 20.0),
        (1000, 10, 20, 10, 20.0),
        (512, 1, 20, 10, 20.0),
        (512, 10, 32, 10, 3.0),
        (512, 10, 20, 0, 20.0),
    ])
    def test_tiling_edges(self, n, v, k, max_it, extent):
        rng = np.random.default_rng(10 + n + v + k + max_it)
        map_pts, src, mask = setup_cloud(rng, n=n, extent=extent)
        if k > 20:  # some voxels hold more than 20 points
            _, counts = np.unique(np.floor(map_pts), axis=0,
                                  return_counts=True)
            assert counts.max() > 20
        guess = _guess(0.02, -0.01, 0.01)
        out, ref = _solve_both(map_pts, src, mask, guess, 0.5, v, k,
                               max_num_iterations=max_it)
        _assert_match(out, ref, guess, 60.0)
        if max_it == 0:
            assert int(out[1]) == 0
        if n >= 33:
            assert int(out[2]) > n // 4


def test_backend_validation():
    map_pts, src, mask = setup_cloud(np.random.default_rng(3), n=64,
                                     nmap=200)
    _, tm = _maps(map_pts)
    tsrc = TP3.from_array(torch.from_numpy(src))
    tc = thm.gather_candidates(tm, tsrc, 1.0, 4, 10)
    args = (tc, tsrc, torch.from_numpy(mask), torch.eye(4), 0.5)
    with pytest.raises(ValueError):
        gn.gn_solve(*args, backend="pallas", **SOLVE)
    a = gn.gn_solve(*args, backend="torch", **SOLVE)
    b = gn.gn_solve(*args, backend="cuda", **SOLVE)  # CPU: plain version
    assert torch.equal(a[0], b[0])
