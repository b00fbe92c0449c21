"""Port vs JAX: the voxel hash map is bit-equal after the same operations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu.ops import hashmap as jhm
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu_torch.ops import hashmap as thm
from kinematic_icp_tpu_torch.ops.points import P3 as TP3

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

CAP, K, G = 1 << 10, 20, 4


def _planes(a):
    return (JP3.from_array(jnp.asarray(a)), TP3.from_array(torch.from_numpy(a)))


def _table_equal(tm, jm):
    np.testing.assert_array_equal(tm.table.numpy().view(np.uint32),
                                  np.asarray(jm.table))


def _insert_both(jm, tm, pts, mask, max_extent):
    jp, tp = _planes(pts)
    jm, jf = jhm.insert(jm, jp, jnp.asarray(mask), 1.0, G,
                        max_extent=max_extent, return_failed=True)
    tm, tf = thm.insert(tm, tp, torch.from_numpy(mask), 1.0, G,
                        max_extent=max_extent, return_failed=True)
    return jm, tm, int(jf), int(tf)


def _maps():
    return jhm.empty(CAP, K, bucket_slots=G), thm.empty(CAP, K, bucket_slots=G)


class TestHashes:
    def test_fingerprint_and_bucket(self):
        rng = np.random.default_rng(0)
        c = rng.integers(-2**31, 2**31 - 1, (3, 5000), dtype=np.int64
                         ).astype(np.int32)
        j = [jnp.asarray(a) for a in c]
        t = [torch.from_numpy(a) for a in c]
        np.testing.assert_array_equal(
            thm.fingerprint(*t).numpy().view(np.uint32),
            np.asarray(jhm.fingerprint(*j)))
        np.testing.assert_array_equal(thm.bucket_of(*t, 1 << 14).numpy(),
                                      np.asarray(jhm.bucket_of(*j, 1 << 14)))

    def test_pack_unpack_offsets(self):
        rng = np.random.default_rng(1)
        pts = rng.uniform(-30, 30, (4000, 3)).astype(np.float32)
        jp, tp = _planes(pts)
        b = np.floor(pts).astype(np.int32)
        jw = jhm.pack_offsets(jp, *(jnp.asarray(b[:, i]) for i in range(3)),
                              1.0)
        tw = thm.pack_offsets(tp, *(torch.from_numpy(b[:, i])
                                    for i in range(3)), 1.0)
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(jw))
        ju = jhm.unpack_offsets(jw, *(jnp.asarray(b[:, i]) for i in range(3)),
                                1.0)
        tu = thm.unpack_offsets(tw, *(torch.from_numpy(b[:, i])
                                      for i in range(3)), 1.0)
        for a, r in zip(tu, ju):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


class TestInsert:
    @pytest.mark.parametrize("max_extent", [None, 120.0],
                             ids=["four-key", "packed-key"])
    def test_insert_sequence_bit_equal(self, max_extent):
        rng = np.random.default_rng(2)
        jm, tm = _maps()
        failed_total = 0
        for step in range(4):
            # dense cloud in a small box: blocks fill, buckets overflow
            pts = rng.uniform(-12, 12, (3000, 3)).astype(np.float32) \
                + np.float32(step)
            mask = rng.uniform(size=3000) < 0.9
            jm, tm, jf, tf = _insert_both(jm, tm, pts, mask, max_extent)
            assert tf == jf
            failed_total += tf
            _table_equal(tm, jm)
        assert failed_total > 0  # the bucket-overflow path ran
        np.testing.assert_array_equal(thm.slot_counts(tm).numpy(),
                                      np.asarray(jhm.slot_counts(jm)))
        assert int(thm.num_voxels(tm)) == int(jhm.num_voxels(jm))

    def test_evict_far_and_update(self):
        rng = np.random.default_rng(3)
        jm, tm = _maps()
        pts = rng.uniform(-30, 30, (2000, 3)).astype(np.float32)
        mask = np.ones(2000, bool)
        jm, tm, _, _ = _insert_both(jm, tm, pts, mask, None)
        origin = np.array([5.0, -3.0, 0.5], np.float32)
        je = jhm.evict_far(jm, jnp.asarray(origin), 15.0, 1.0)
        te = thm.evict_far(tm, torch.from_numpy(origin), 15.0, 1.0)
        _table_equal(te, je)
        assert int(thm.num_voxels(te)) < int(thm.num_voxels(tm))

        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = origin
        jp, tp = _planes(pts[:500] + 1.5)
        ju, jf = jhm.update(jm, jp, jnp.ones(500, bool), jnp.asarray(pose),
                            1.0, 20.0, G, enable=jnp.bool_(True),
                            return_failed=True)
        tu, tf = thm.update(tm, tp, torch.ones(500, dtype=torch.bool),
                            torch.from_numpy(pose), 1.0, 20.0, G,
                            enable=torch.tensor(True), return_failed=True)
        _table_equal(tu, ju)
        assert int(tf) == int(jf)

        # a disabled update leaves the table byte-identical
        off, _ = thm.update(tm, tp, torch.ones(500, dtype=torch.bool),
                            torch.from_numpy(pose), 1.0, 20.0, G,
                            enable=torch.tensor(False), return_failed=True)
        assert torch.equal(off.table, tm.table)

    def test_empty_and_clear(self):
        jm, tm = _maps()
        _table_equal(tm, jm)
        rng = np.random.default_rng(4)
        pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        _, tm, _, _ = _insert_both(jm, tm, pts, np.ones(300, bool), None)
        assert not bool(thm.is_empty(tm))
        _table_equal(thm.clear(tm), jm)


class TestCandidates:
    @pytest.mark.parametrize("v", [10, 27])
    def test_gather_and_nn_bit_equal(self, v):
        rng = np.random.default_rng(5)
        jm, tm = _maps()
        pts = rng.uniform(-15, 15, (3000, 3)).astype(np.float32)
        jm, tm, _, _ = _insert_both(jm, tm, pts, np.ones(3000, bool), 120.0)
        q = (pts[:700] + rng.normal(0, 0.3, (700, 3))).astype(np.float32)
        q[600:] = rng.uniform(-40, 40, (100, 3))  # some with no neighbours
        qmask = rng.uniform(size=700) < 0.9
        jq, tq = _planes(q)
        jc = jhm.gather_candidates(jm, jq, 1.0, G, v)
        tc = thm.gather_candidates(tm, tq, 1.0, G, v)
        np.testing.assert_array_equal(tc.words.numpy().view(np.uint32),
                                      np.asarray(jc.words))
        for name in ("rel", "base_x", "base_y", "base_z"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))
        jn, jd = jhm.nn_from_candidates(jc, jq, jnp.asarray(qmask), 1.0)
        tn, td = thm.nn_from_candidates(tc, tq, torch.from_numpy(qmask), 1.0)
        for a, b in zip(tn, jn):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the winner is bit-equal; its distance is recomputed in float32,
        # where XLA's CPU code may fuse a multiply-add: 1 ulp
        jd = np.asarray(jd)
        np.testing.assert_array_equal(np.isinf(td.numpy()), np.isinf(jd))
        np.testing.assert_allclose(td.numpy(), jd, rtol=2.4e-7, atol=0)
        assert np.isinf(jd).any() and np.isfinite(jd).any()
