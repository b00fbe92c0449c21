"""Port vs JAX: the frame upload codec (host pack, device unpack)."""

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
