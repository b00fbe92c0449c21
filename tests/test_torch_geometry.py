"""Port vs JAX: SE(3), the unicycle motion model and point transforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu.ops import motion_model as jmm
from kinematic_icp_tpu.ops import points as jpoints
from kinematic_icp_tpu.ops import se3 as jse3
from kinematic_icp_tpu.ops import threshold as jthr
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu.ops.points import transform as jtransform
from kinematic_icp_tpu_torch.ops import motion_model as tmm
from kinematic_icp_tpu_torch.ops import points as tpoints
from kinematic_icp_tpu_torch.ops import se3 as tse3
from kinematic_icp_tpu_torch.ops import threshold as tthr
from kinematic_icp_tpu_torch.ops.points import P3 as TP3
from kinematic_icp_tpu_torch.ops.points import transform as ttransform

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

# float32 elementwise formulas evaluated by two compilers: agreement to a
# few ulp of O(1) values
ATOL = 1e-6


def _twists(rng, n=64):
    xi = rng.normal(0, 1.0, (n, 6)).astype(np.float32)
    # rotation magnitudes across every switch point, including the
    # theta < 3.4e-4 range where 1 - cos(theta) is 0 in float32
    mags = np.concatenate([[0.0, 1e-8, 1e-6, 5e-5, 3e-4, 3.4e-4, 1e-3, 0.09,
                            0.11, 0.49, 0.51, 1.0, 2.5, 3.1],
                           rng.uniform(0, 3.0, n - 14)]).astype(np.float32)
    w = xi[:, 3:]
    xi[:, 3:] = w / np.linalg.norm(w, axis=1, keepdims=True) * mags[:, None]
    return xi


def _check(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), a.numpy(), atol=atol, rtol=0)


class TestSE3:
    def test_exp_log_roundtrip_matches_jax(self):
        xi = _twists(np.random.default_rng(0))
        T_t = tse3.se3_exp(torch.from_numpy(xi))
        _check(T_t, jse3.se3_exp(jnp.asarray(xi)))
        _check(tse3.se3_log(T_t), jse3.se3_log(jnp.asarray(T_t.numpy())),
               atol=2e-6)

    def test_so3_exp_log(self):
        w = _twists(np.random.default_rng(1))[:, 3:].copy()
        R = tse3.so3_exp(torch.from_numpy(w))
        _check(R, jse3.so3_exp(jnp.asarray(w)))
        _check(tse3.so3_log(R), jse3.so3_log(jnp.asarray(R.numpy())),
               atol=2e-6)

    def test_small_angle_log_is_finite_and_exact(self):
        # theta < 3.4e-4: the naive 1 - cos form returns NaN translation
        for theta in (0.0, 1e-7, 1e-5, 2e-4, 3.3e-4):
            xi = np.array([0.5, -0.2, 0.01, 0.0, 0.0, theta], np.float32)
            T = tse3.se3_exp(torch.from_numpy(xi))
            out = tse3.se3_log(T).numpy()
            assert np.all(np.isfinite(out))
            np.testing.assert_allclose(out, xi, atol=1e-6)
            _check(tse3.se3_log(T), jse3.se3_log(jnp.asarray(T.numpy())))

    def test_inverse_compose_rotation_angle(self):
        xi = _twists(np.random.default_rng(2), 32)
        T = tse3.se3_exp(torch.from_numpy(xi))
        Tj = jnp.asarray(T.numpy())
        _check(tse3.inverse(T), jse3.inverse(Tj))
        _check(tse3.compose44(T, tse3.inverse(T)),
               jse3.compose44(Tj, jse3.inverse(Tj)))
        _check(tse3.compose44(T[:-1], T[1:]), jse3.compose44(Tj[:-1], Tj[1:]))
        # arccos at 1 turns a 1-ulp trace difference into sqrt(2 * 1.2e-7)
        _check(tse3.rotation_angle(T), jse3.rotation_angle(Tj), atol=5e-4)

    def test_float64(self):
        xi = _twists(np.random.default_rng(3)).astype(np.float64)
        T = tse3.se3_exp(torch.from_numpy(xi))
        assert T.dtype == torch.float64
        np.testing.assert_allclose(tse3.se3_log(T).numpy(), xi, atol=1e-9)


class TestMotionModel:
    @pytest.mark.parametrize("theta", [0.0, 1e-7, 1e-5, 3e-4, 1e-3, 0.2,
                                       -0.7, 2.0])
    def test_matches_jax(self, theta):
        c = np.array([[0.37, theta], [-1.2, theta]], np.float32)
        _check(tmm.control_to_twist(torch.from_numpy(c)),
               jmm.control_to_twist(jnp.asarray(c)))
        _check(tmm.motion_model(torch.from_numpy(c)),
               jmm.motion_model(jnp.asarray(c)))


def test_transform_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-50, 50, (1000, 3)).astype(np.float32)
    pose = tse3.se3_exp(torch.from_numpy(_twists(rng, 14)[5])).numpy()
    out = ttransform(torch.from_numpy(pose), TP3.from_array(
        torch.from_numpy(pts)))
    ref = jtransform(jnp.asarray(pose), JP3.from_array(jnp.asarray(pts)))
    for a, b in zip(out, ref):
        # 50 m coordinates: a few ulp is ~1e-5 absolute
        np.testing.assert_allclose(np.asarray(b), a.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("use_adaptive", [True, False])
def test_odometry_error_update_matches_jax(use_adaptive):
    """The threshold's se3 path (the loop branches' odometry error): the
    trace is summed alike, so the point-space errors differ only by libm's
    arccos and sin, a few ulp of values up to 2 * max_range."""
    poses = tse3.se3_exp(torch.from_numpy(
        _twists(np.random.default_rng(6), 32))).numpy()
    err = tthr.odometry_error_in_point_space(torch.from_numpy(poses), 60.0)
    ref = jthr.odometry_error_in_point_space(jnp.asarray(poses), 60.0)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
    tstate = tthr.ThresholdState(torch.tensor(0.5), torch.tensor(3.0))
    jstate = jthr.ThresholdState(jnp.float32(0.5), jnp.float32(3.0))
    for pose in poses[:4]:
        tstate = tthr.update_odometry_error(
            tstate, torch.from_numpy(pose), max_range=60.0,
            use_adaptive=use_adaptive)
        jstate = jthr.update_odometry_error(
            jstate, jnp.asarray(pose), max_range=60.0,
            use_adaptive=use_adaptive)
    np.testing.assert_allclose(float(tstate.odom_sse),
                               float(jstate.odom_sse), rtol=1e-5)
    assert float(tstate.num_samples) == float(jstate.num_samples) == (
        7.0 if use_adaptive else 3.0)


def _planes(rng, shape):
    return [rng.normal(0, 20.0, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("name", ["norm2", "norm", "sub", "dot", "where",
                                  "zeros_like"])
def test_point_helpers_bit_equal_to_jax(name, batched):
    """Each P3 helper against JAX's on the same float32 planes, (N,) or a
    (B, N) batch: bit-equal (elementwise, unfused on both sides).  ``where``
    in a batch takes a per-point or a per-sequence (B,) condition, the
    latter held to JAX's with the condition broadcast over the points."""
    rng = np.random.default_rng(12)
    shape = (3, 257) if batched else (257,)
    a, b = _planes(rng, shape), _planes(rng, shape)
    ta, tb = TP3(*map(torch.from_numpy, a)), TP3(*map(torch.from_numpy, b))
    ja, jb = JP3(*map(jnp.asarray, a)), JP3(*map(jnp.asarray, b))
    conds = [rng.uniform(size=shape) < 0.5]
    if batched:
        conds.append(np.array([True, False, True]))
    for cond in conds:
        if name in ("norm2", "norm", "zeros_like"):
            got, want = getattr(tpoints, name)(ta), getattr(jpoints, name)(ja)
        elif name == "where":
            got = tpoints.where(torch.from_numpy(cond), ta, tb)
            want = jpoints.where(jnp.asarray(np.broadcast_to(
                cond.reshape(cond.shape + (1,) * (len(shape) - cond.ndim)),
                shape)), ja, jb)
        else:
            got = getattr(tpoints, name)(ta, tb)
            want = getattr(jpoints, name)(ja, jb)
        if isinstance(got, TP3):
            assert isinstance(want, JP3)
            got, want = list(got), list(want)
        else:
            got, want = [got], [want]
        for g, w in zip(got, want):
            assert tuple(g.shape) == shape and g.dtype == torch.float32
            if name == "norm":
                # torch's CPU float32 sqrt (a vector kernel) is not
                # correctly rounded (~0.7 % of values 1 ulp off numpy's
                # and XLA's): bit-equal to torch.sqrt of JAX's norm2 bits,
                # within 1 ulp of JAX's norm
                np.testing.assert_array_equal(g.numpy(), torch.sqrt(
                    torch.from_numpy(np.asarray(jpoints.norm2(ja)))).numpy())
                np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), 1)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_row_sum_of_a_row_does_not_depend_on_the_batch(b, n):
    """Row i of a (B, N) ``row_sum`` is the bits of that row summed alone,
    and of it inside (B, 5, N) stacks as the loop lowering sums them."""
    rng = np.random.default_rng(b * 10_000 + n)
    x = torch.from_numpy(rng.normal(0, 3.0, (b, 5, n)).astype(np.float32))
    got = tpoints.row_sum(x)
    assert got.shape == (b, 5) and got.dtype == torch.float32
    for i in range(b):
        assert torch.equal(tpoints.row_sum(x[i]), got[i])
        for k in range(5):
            assert torch.equal(tpoints.row_sum(x[i, k]), got[i, k])
            assert torch.equal(tpoints.row_sum(x[i, k:k + 1, :]),
                               got[i, k:k + 1])


@pytest.mark.parametrize("n", [0, 1, 3, 1000, 1024, 8192])
def test_row_sum_agrees_with_torch_sum_in_float64(n):
    """A pairwise tree of N terms rounds at most ceil(log2 N) times on the
    way to each sum, so its error is at most ceil(log2 N) * u * sum|x_i|
    (Higham, Accuracy and Stability of Numerical Algorithms, 4.2; u the
    unit roundoff).  float32 is held to that bound, plus one rounding of
    the inputs, against float64 ``torch.sum``; float64 likewise, u =
    2**-53."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 3.0, (4, n))
    exact = torch.sum(torch.from_numpy(x), dim=-1).numpy()
    steps = max(n - 1, 0).bit_length()
    mag = np.abs(x).sum(-1)
    got32 = tpoints.row_sum(torch.from_numpy(x.astype(np.float32)))
    assert got32.dtype == torch.float32
    np.testing.assert_array_less(np.abs(got32.double().numpy() - exact),
                                 (steps + 1) * 2.0 ** -24 * mag + 1e-300)
    got64 = tpoints.row_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_less(np.abs(got64 - exact),
                                 (2 * steps + 1) * 2.0 ** -53 * mag + 1e-300)
