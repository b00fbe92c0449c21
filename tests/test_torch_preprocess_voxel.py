"""Port vs JAX: deskew, range mask and voxel downsampling (both paths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu.ops import preprocessing as jpre
from kinematic_icp_tpu.ops import voxel as jvox
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu_torch.ops import preprocessing as tpre
from kinematic_icp_tpu_torch.ops import voxel as tvox
from kinematic_icp_tpu_torch.ops.points import P3 as TP3

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)


def _planes(a):
    return (JP3.from_array(jnp.asarray(a)), TP3.from_array(torch.from_numpy(a)))


def _cloud(rng, n, extent=40.0):
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    # duplicate voxels on purpose: every tiebreak decides something
    pts[n // 2:n // 2 + n // 8] = pts[:n // 8] + rng.uniform(
        -0.05, 0.05, (n // 8, 3)).astype(np.float32)
    return pts


class TestPreprocess:
    @pytest.mark.parametrize("twist", [
        [0.5, 0.02, 0.0, 0.0, 0.0, 0.05],   # turning
        [0.5, 0.0, 0.0, 0.0, 0.0, 2e-4],    # nearly straight (1-cos == 0)
        [0.4, -0.1, 0.01, 0.0, 0.0, 0.0],   # pure translation
    ])
    def test_deskew_matches_jax(self, twist):
        rng = np.random.default_rng(0)
        pts = _cloud(rng, 4096)
        ts = rng.uniform(0, 1, 4096).astype(np.float32)
        xi = np.asarray(twist, np.float32)
        jp, tp = _planes(pts)
        ref = jpre.deskew_from_twist(jp, jnp.asarray(ts), jnp.asarray(xi),
                                     jnp.bool_(True))
        out = tpre.deskew_from_twist(tp, torch.from_numpy(ts),
                                     torch.from_numpy(xi), torch.tensor(True))
        for a, b in zip(out, ref):
            # sin/cos of two libraries: a few ulp of 40 m coordinates
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                       rtol=0)

    def test_preprocess_mask_bit_equal_and_drops_nan(self):
        rng = np.random.default_rng(1)
        pts = _cloud(rng, 2048, extent=80.0)
        pts[::37] = np.nan
        ts = rng.uniform(0, 1, 2048).astype(np.float32)
        mask = rng.uniform(size=2048) < 0.95
        xi = np.asarray([0.3, 0.0, 0.0, 0.0, 0.0, 0.02], np.float32)
        jp, tp = _planes(pts)
        _, jm = jpre.preprocess(jp, jnp.asarray(ts), jnp.asarray(mask), None,
                                min_range=1.0, max_range=60.0,
                                deskew_enabled=True,
                                has_timestamps=jnp.bool_(False),
                                twist=jnp.asarray(xi))
        _, tm = tpre.preprocess(tp, torch.from_numpy(ts),
                                torch.from_numpy(mask), None,
                                min_range=1.0, max_range=60.0,
                                deskew_enabled=True,
                                has_timestamps=torch.tensor(False),
                                twist=torch.from_numpy(xi))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert not tm.numpy()[::37].any()

    def test_range_filter_strict(self):
        pts = np.array([[1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0],
                        [np.nan, 0, 0]], np.float32)
        jp, tp = _planes(pts)
        m = np.ones(4, bool)
        ref = jpre.range_filter_mask(jp, jnp.asarray(m), 1.0, 3.0)
        out = tpre.range_filter_mask(tp, torch.from_numpy(m), 1.0, 3.0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert out.tolist() == [False, True, False, False]


def _compare_downsample(pts, mask, voxel_size, out_size, max_extent,
                        tiebreak):
    jp, tp = _planes(pts)
    jo, jm, jd = jvox.voxel_downsample(jp, jnp.asarray(mask), voxel_size,
                                       out_size, max_extent=max_extent,
                                       tiebreak=tiebreak)
    to, tm, td = tvox.voxel_downsample(tp, torch.from_numpy(mask), voxel_size,
                                       out_size, max_extent=max_extent,
                                       tiebreak=tiebreak)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert int(td) == int(jd)
    for a, b in zip(to, jo):
        # rows past the mask are unspecified padding in both packages
        np.testing.assert_array_equal(a.numpy()[jm], np.asarray(b)[jm])
    return int(jm.sum()), int(td)


class TestVoxelDownsample:
    @pytest.mark.parametrize("max_extent", [None, 120.0],
                             ids=["three-key", "packed-key"])
    def test_narrow_path_bit_equal(self, max_extent):
        rng = np.random.default_rng(2)
        pts = _cloud(rng, 4096)
        mask = rng.uniform(size=4096) < 0.9
        kept, dropped = _compare_downsample(pts, mask, 1.0, 4096, max_extent,
                                            "first")
        assert kept > 1000 and dropped == 0
        # undersized output: the drop count is exact too
        _, dropped = _compare_downsample(pts, mask, 1.0, 512, max_extent,
                                         "first")
        assert dropped > 0

    @pytest.mark.parametrize("tiebreak", ["first", "min"])
    def test_packed_word_path_bit_equal(self, tiebreak):
        n = tvox.PACKED_WORD_MIN_N
        rng = np.random.default_rng(3)
        pts = _cloud(rng, n, extent=30.0)
        mask = rng.uniform(size=n) < 0.9
        kept, _ = _compare_downsample(pts, mask, 0.5, 8192, 120.0, tiebreak)
        assert kept == 8192  # the packed path also counts its drops
        _compare_downsample(pts, mask, 2.0, 8192, 120.0, tiebreak)

    def test_double_downsample_bit_equal(self):
        n = tvox.PACKED_WORD_MIN_N
        rng = np.random.default_rng(4)
        pts = _cloud(rng, n, extent=30.0)
        mask = rng.uniform(size=n) < 0.95
        jp, tp = _planes(pts)
        ref = jvox.double_downsample(jp, jnp.asarray(mask), 1.0,
                                     max_downsampled=16384, max_source=2048,
                                     max_extent=120.0)
        out = tvox.double_downsample(tp, torch.from_numpy(mask), 1.0,
                                     max_downsampled=16384, max_source=2048,
                                     max_extent=120.0)
        for planes, m in ((0, 1), (2, 3)):
            jm = np.asarray(ref[m])
            np.testing.assert_array_equal(out[m].numpy(), jm)
            for a, b in zip(out[planes], ref[planes]):
                np.testing.assert_array_equal(a.numpy()[jm],
                                              np.asarray(b)[jm])
        np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
