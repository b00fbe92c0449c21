"""Port vs JAX: the batched multi-sequence path.

Every op with a leading batch axis against ``jax.vmap`` of the JAX op, the
port's batched sequence runner against JAX's and against one port run per
sequence, ``BatchedOdometryRunner`` against JAX's, and batched states
carried across both packages.  The Pallas kernel runs in interpret mode,
as ``tests/test_pallas_gn.py`` runs it on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu import offline as joffline
from kinematic_icp_tpu.ops import hashmap as jhm
from kinematic_icp_tpu.ops import pallas_gn
from kinematic_icp_tpu.ops import voxel as jvox
from kinematic_icp_tpu.ops.points import P3 as JP3
from kinematic_icp_tpu.ops.points import transform as jtransform
from kinematic_icp_tpu.parallel import BatchedOdometryRunner as JRunner
from kinematic_icp_tpu.parallel import make_mesh
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.convert import state_from_numpy, state_to_numpy
from kinematic_icp_tpu_torch.models import pipeline as tpipe
from kinematic_icp_tpu_torch.oracle.reference import se3_log
from kinematic_icp_tpu_torch.ops import gn
from kinematic_icp_tpu_torch.ops import hashmap as thm
from kinematic_icp_tpu_torch.ops import voxel as tvox
from kinematic_icp_tpu_torch.ops.points import P3 as TP3
from kinematic_icp_tpu_torch.parallel import BatchedOdometryRunner
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_parallel.py:20-22
CFG = JConfig(max_points=4096, max_downsampled=4096, max_source=2048,
              map_capacity=1 << 13, voxel_size=1.0, max_range=60.0,
              deskew=True)
#: tests/test_torch_pipeline.py's drive configuration and sensor, for the
#: tests that run the port alone or JAX's sharded step
SMALL = JConfig(max_points=1024, max_downsampled=1024, max_source=512,
                map_capacity=4096, voxel_size=1.0, max_range=15.0,
                max_probes=4, deskew=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
NUM_FRAMES = 8
#: the ragged row's length
SHORT = 5
SOLVE = dict(voxel_size=1.0, max_num_iterations=10,
             convergence_criterion=0.001, use_adaptive_regularization=True,
             fixed_regularization=0.0, max_range=60.0)
G = 4  # bucket slots of the op tests' maps


def _vmap(fn):
    """``jax.vmap`` under ``jit``: one compile instead of op-by-op batching
    rules (several times faster on a CPU)."""
    return jax.jit(jax.vmap(fn))


def _port_cfg(jcfg):
    return Config.from_dict(dataclasses.asdict(jcfg))


def _u32(t):
    return t.numpy().view(np.uint32)


def _stack_planes(arrays):
    """(B, N, 3) numpy -> (JAX P3, port P3) of (B, N) planes."""
    a = np.ascontiguousarray(arrays)
    return JP3.from_array(jnp.asarray(a)), TP3.from_array(torch.from_numpy(a))


def _guess(tx, ty=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, tx], [s, c, 0, ty], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)


# --- (i) the GN solve ------------------------------------------------------

def test_gn_reference_batched_matches_vmapped_pallas():
    """Three problems shaped like tests/test_pallas_gn.py:20-31 (a 3,000
    point map, 512 noisy sources), each with its own guess, solved as one
    batch: each frame stops at its own iteration."""
    rng = np.random.default_rng(0)
    guesses = np.stack([_guess(0.02, -0.01, 0.01), _guess(0.3, 0.1, -0.02),
                        _guess(-0.1, 0.05, 0.04)])
    cands, srcs, masks = [], [], []
    for b in range(3):
        map_pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
        src = (map_pts[:512] + rng.normal(0, 0.05, (512, 3))
               ).astype(np.float32)
        masks.append(rng.uniform(size=512) < 0.9)
        m = jhm.insert(jhm.empty(1 << 13, 20), JP3.from_array(
            jnp.asarray(map_pts)), jnp.ones(3000, bool), 1.0, 4)
        jsrc = JP3.from_array(jnp.asarray(src))
        cands.append(jhm.gather_candidates(
            m, jtransform(jnp.asarray(guesses[b]), jsrc), 1.0, 4, 10))
        srcs.append(src)
    jc = jax.tree.map(lambda *x: jnp.stack(x), *cands)
    jsrc, tsrc = _stack_planes(np.stack(srcs))
    mask = np.stack(masks)
    ref = _vmap(lambda c, s, mk, g: pallas_gn.gn_solve(
        c, s, mk, g, 0.5, interpret=True, **SOLVE))(
            jc, jsrc, jnp.asarray(mask), jnp.asarray(guesses))
    tc = thm.CandidateSet(*(torch.from_numpy(np.asarray(a).view(np.int32))
                            for a in jc))
    before = gn.LAUNCHES
    out = gn.gn_solve(tc, tsrc, torch.from_numpy(mask),
                      torch.from_numpy(guesses), torch.full((3,), 0.5),
                      **SOLVE)
    assert gn.LAUNCHES == before  # CPU tensors take the plain version
    iters = out[1].numpy()
    assert out[0].shape == (3, 4, 4) and iters.shape == (3,)
    assert len(set(iters.tolist())) > 1, iters  # the frames stop apart
    np.testing.assert_array_equal(iters, np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-7,
                               rtol=0)
    # each frame of the batch is its own unbatched solve, bit for bit
    for b in range(3):
        one = gn.gn_solve(thm.CandidateSet(*(t[b] for t in tc)),
                          TP3(*(t[b] for t in tsrc)),
                          torch.from_numpy(mask[b]),
                          torch.from_numpy(guesses[b]), 0.5, **SOLVE)
        for x, y in zip(out, one):
            assert torch.equal(x[b], y)


# --- (ii) the ops ----------------------------------------------------------

def _frames(rng, b, n, extent=30.0):
    pts = rng.uniform(-extent, extent, (b, n, 3)).astype(np.float32)
    pts[:, : n // 4] = np.round(pts[:, : n // 4])  # voxel-boundary points
    mask = rng.uniform(size=(b, n)) < 0.9
    return pts, mask


@pytest.mark.parametrize("n,max_extent", [(2048, None), (2048, 120.0),
                                          (32768, 120.0)],
                         ids=["lexsort", "packed-key", "packed-word"])
def test_double_downsample_batched(n, max_extent):
    pts, mask = _frames(np.random.default_rng(1), 3, n)
    mask[2] = False  # an empty row
    kw = dict(max_downsampled=1024, max_source=256, max_extent=max_extent)
    jp, tp = _stack_planes(pts)
    ref = _vmap(lambda p, mk: jvox.double_downsample(p, mk, 1.0, **kw))(
        jp, jnp.asarray(mask))
    out = tvox.double_downsample(tp, torch.from_numpy(mask), 1.0, **kw)
    for i in (1, 3, 4):  # masks and the (B, 2) drop counts
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]))
    for i in (0, 2):  # the kept points, bit-equal (JAX's compaction sort
        keep = np.asarray(ref[i + 1])  # is unstable past the kept rows)
        for a, r in zip(out[i], ref[i]):
            np.testing.assert_array_equal(a.numpy()[keep], np.asarray(r)[keep])
    assert out[4].shape == (3, 2) and out[4][0].sum() > 0


def _batched_maps(rng, b, n, max_extent):
    """B maps built from their own points, in both packages."""
    pts, mask = _frames(rng, b, n, extent=10.0)
    jp, tp = _stack_planes(pts)
    jm = _vmap(lambda _: jhm.empty(512, 8, bucket_slots=G))(jnp.arange(b))
    tm = thm.MapState(table=thm.empty(512, 8, bucket_slots=G).table.expand(
        b, -1, -1).clone(), bucket_slots=G)
    jm, jf = _vmap(lambda m, p, mk: jhm.insert(
        m, p, mk, 1.0, G, max_extent=max_extent, return_failed=True))(
            jm, jp, jnp.asarray(mask))
    tm, tf = thm.insert(tm, tp, torch.from_numpy(mask), 1.0, G,
                        max_extent=max_extent, return_failed=True)
    return jm, tm, np.asarray(jf), tf.numpy()


@pytest.mark.parametrize("max_extent", [None, 120.0],
                         ids=["four-key", "packed-key"])
def test_insert_batched(max_extent):
    rng = np.random.default_rng(2)
    jm, tm, jf, tf = _batched_maps(rng, 3, 3000, max_extent)
    assert tm.table.shape == (3, 128, G * 12)
    np.testing.assert_array_equal(_u32(tm.table), np.asarray(jm.table))
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape == (3,) and (tf > 0).all()  # 512 slots overflow
    # a second insert into the filled maps
    pts, mask = _frames(rng, 3, 1000, extent=12.0)
    jp, tp = _stack_planes(pts)
    jm, jf = _vmap(lambda m, p, mk: jhm.insert(
        m, p, mk, 1.0, G, max_extent=max_extent, return_failed=True))(
            jm, jp, jnp.asarray(mask))
    tm2, tf = thm.insert(tm, tp, torch.from_numpy(mask), 1.0, G,
                         max_extent=max_extent, return_failed=True)
    np.testing.assert_array_equal(_u32(tm2.table), np.asarray(jm.table))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # a row equals the unbatched insert of its own points into its map
    one, one_f = thm.insert(
        thm.MapState(table=tm.table[1], bucket_slots=G),
        TP3(*(t[1] for t in tp)), torch.from_numpy(mask[1]), 1.0, G,
        max_extent=max_extent, return_failed=True)
    assert torch.equal(one.table, tm2.table[1])
    assert int(one_f) == int(tf[1])


def test_update_and_evict_far_batched():
    rng = np.random.default_rng(3)
    jm, tm, _, _ = _batched_maps(rng, 3, 2000, 120.0)
    pts, mask = _frames(rng, 3, 800, extent=8.0)
    jp, tp = _stack_planes(pts)
    poses = np.stack([_guess(4.0, 1.0, 0.3), _guess(-3.0, 2.0, -0.2),
                      _guess(6.0, -5.0, 1.0)])
    enable = np.array([True, False, True])
    jm2, jf = _vmap(lambda m, p, mk, pose, en: jhm.update(
        m, p, mk, pose, 1.0, 9.0, G, enable=en, max_extent=120.0,
        return_failed=True))(jm, jp, jnp.asarray(mask), jnp.asarray(poses),
                             jnp.asarray(enable))
    tm2, tf = thm.update(tm, tp, torch.from_numpy(mask),
                         torch.from_numpy(poses), 1.0, 9.0, G,
                         enable=torch.from_numpy(enable), max_extent=120.0,
                         return_failed=True)
    np.testing.assert_array_equal(_u32(tm2.table), np.asarray(jm2.table))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # the disabled row is byte-identical; the others lost far voxels
    assert torch.equal(tm2.table[1], tm.table[1])
    counts = thm.num_voxels(tm2).numpy()
    assert counts.shape == (3,) and counts[2] < thm.num_voxels(tm)[2]

    origins = np.array([[0.0, 0.0, 0.0], [5.0, 5.0, 0.0], [-4.0, 2.0, 1.0]],
                       np.float32)
    jm3 = _vmap(lambda m, o, en: jhm.evict_far(m, o, 6.0, 1.0,
                                                  enable=en))(
        jm, jnp.asarray(origins), jnp.asarray(enable))
    tm3 = thm.evict_far(tm, torch.from_numpy(origins), 6.0, 1.0,
                        enable=torch.from_numpy(enable))
    np.testing.assert_array_equal(_u32(tm3.table), np.asarray(jm3.table))


@pytest.mark.parametrize("v", [10, 27])
def test_gather_candidates_batched(v):
    rng = np.random.default_rng(4)
    jm, tm, _, _ = _batched_maps(rng, 3, 3000, 120.0)
    q = rng.uniform(-11, 11, (3, 300, 3)).astype(np.float32)
    jq, tq = _stack_planes(q)
    jc, jskip = _vmap(lambda m, p: jhm.gather_candidates(
        m, p, 1.0, G, v, return_skip_bound=True))(jm, jq)
    tc, tskip = thm.gather_candidates(tm, tq, 1.0, G, v,
                                      return_skip_bound=True)
    assert tc.words.shape == (3, v, 8, 300)
    np.testing.assert_array_equal(_u32(tc.words), np.asarray(jc.words))
    for name in ("rel", "base_x", "base_y", "base_z"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    # the bound is a float: under jit XLA fuses its multiply-adds, and a
    # 1-ulp change moves the key (5 low bits masked) by one 32-ulp step
    np.testing.assert_allclose(tskip.numpy(), np.asarray(jskip),
                               rtol=2.0 ** -18, atol=0)
    assert (tc.words != thm.PACKED_SENTINEL).any(dim=(1, 2, 3)).all()
    # each voxel's 3 nearest (Config.gn_candidates_per_voxel)
    jr = _vmap(lambda c, p: jhm.reduce_candidates(c, p, 3, 1.0))(jc, jq)
    tr = thm.reduce_candidates(tc, tq, 3, 1.0)
    assert tr.words.shape == (3, v, 3, 300)
    np.testing.assert_array_equal(_u32(tr.words), np.asarray(jr.words))


def test_exact_modes_raise_on_a_batch():
    """The exact modes no longer raise on a batch: one batched
    ``register_frame`` per exact mode (certified, full-27 loop, pruned) on
    a batch of two maps gives, in each row, the unbatched call's result on
    that row's inputs, debug values included (tests/test_torch_batched_
    exact.py holds whole drives)."""
    rng = np.random.default_rng(6)
    cfg = Config(max_points=512, max_downsampled=512, max_source=256,
                 map_capacity=2048, max_range=15.0, neighbor_candidates=27,
                 exact_gn_reassociation=True)
    pts = rng.uniform(-6, 6, (2, 2, 512, 3)).astype(np.float32)
    pts[1] = pts[0] + rng.normal(0, 0.02, pts[0].shape).astype(np.float32)
    rel = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    rel[1, :, 0, 3] = (0.1, 0.3)
    rel[1, :, 1, 3] = (0.05, -0.2)
    for mode in (dict(gn_backend="cuda"), dict(gn_backend="torch"),
                 dict(gn_backend="torch", exact_prune_candidates=14)):
        c = cfg.replace(**mode)
        state = toffline.init_batched_state(c, 2, device=CPU)
        rows = [tpipe.init_state(c, device=CPU) for _ in range(2)]
        for f in range(2):
            args = (torch.zeros(2, 512), torch.ones(2, 512, dtype=torch.bool),
                    torch.zeros(2, dtype=torch.bool), torch.eye(4))
            state, out = tpipe.register_frame(
                state, torch.from_numpy(pts[f]), *args,
                torch.from_numpy(rel[f]), c)
            for i in range(2):
                rows[i], one = tpipe.register_frame(
                    rows[i], torch.from_numpy(pts[f, i]),
                    *(a[i] for a in args[:3]), args[3],
                    torch.from_numpy(rel[f, i]), c)
                assert torch.equal(state.pose[i], rows[i].pose), mode
                assert torch.equal(state.map.table[i], rows[i].map.table)
                for a, b in zip(out.debug, one.debug):
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert torch.equal(a[i], b), mode


# --- (iii)-(iv) the batched sequence runner --------------------------------

def _drives(**kw):
    """Three drives (tests/test_parallel.py's seeds), the third cut to
    SHORT frames."""
    seqs = [synthetic.make_sequence(NUM_FRAMES, world_seed=s,
                                    traj_seed=s + 10, noise_seed=s + 20, **kw)
            for s in range(3)]
    seqs[2] = dict(seqs[2], frames=seqs[2]["frames"][:SHORT],
                   rel_odometry=seqs[2]["rel_odometry"][:SHORT])
    return seqs


@pytest.fixture(scope="module")
def sequences():
    return _drives()


@pytest.fixture(scope="module")
def small_sequences():
    return _drives(lidar=synthetic.LidarModel(**LIDAR))


@pytest.fixture(scope="module")
def jax_batched(sequences):
    arrays = toffline.pad_batch(sequences, _port_cfg(CFG))
    runner = joffline.make_batched_sequence_runner(CFG)
    state, poses, overflow, _ = runner(
        joffline.init_batched_state(CFG, len(sequences)),
        *(jnp.asarray(a) for a in arrays[:4]), jnp.eye(4),
        jnp.asarray(arrays[4]))
    return state, np.asarray(poses), np.asarray(overflow)


def _port_batched(seqs, cfg):
    arrays = toffline.pad_batch(seqs, cfg)
    runner = toffline.make_batched_sequence_runner(cfg, device=CPU)
    # (state, poses, overflow, fallbacks), without the counts
    return runner(toffline.init_batched_state(cfg, len(seqs), device=CPU),
                  *(torch.from_numpy(a) for a in arrays[:4]), torch.eye(4),
                  torch.from_numpy(arrays[4]))[:4]


def test_batched_runner_matches_jax(sequences, jax_batched):
    """The JAX batched runner (its "xla" loop on the CPU) against the
    port's kernel branch (the plain version on CPU tensors), with the drive
    tolerances of tests/test_torch_pipeline.py."""
    _, jposes, jover = jax_batched
    _, tposes, tover, fallbacks = _port_batched(
        sequences, _port_cfg(CFG).replace(gn_backend="cuda"))
    tposes = tposes.numpy()
    assert tposes.shape == (NUM_FRAMES, 3, 4, 4)
    np.testing.assert_array_equal(tover.numpy(), jover)
    np.testing.assert_array_equal(fallbacks.numpy(), np.zeros(3))
    np.testing.assert_allclose(tposes[:3], jposes[:3], atol=1e-5)
    for i in range(3):
        assert ate_rmse(list(jposes[:, i]), list(tposes[:, i]),
                        align=False) < 5e-3
    # the ragged row holds its last pose over the padding frames
    for f in range(SHORT, NUM_FRAMES):
        np.testing.assert_array_equal(tposes[f, 2], tposes[SHORT - 1, 2])


@pytest.mark.parametrize("gn_backend", ["torch", "cuda"])
def test_batched_runner_equals_one_run_per_sequence(small_sequences,
                                                    gn_backend):
    """The batch against a run_offline of each sequence: equal overflow,
    poses within 1e-6 and, on the CPU, bit-equal (each op works on its
    row alone; the GN plain version solves the frames one by one)."""
    cfg = _port_cfg(SMALL).replace(gn_backend=gn_backend)
    state, poses, overflow, _ = _port_batched(small_sequences, cfg)
    for i, s in enumerate(small_sequences):
        single, sstate, stats = toffline.run_offline(
            s["frames"], s["rel_odometry"], cfg, device=CPU,
            return_stats=True)
        got = poses[:len(single), i].numpy().astype(np.float64)
        np.testing.assert_allclose(got, single, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got, single)
        np.testing.assert_array_equal(overflow[i].numpy(), stats["overflow"])
        assert torch.equal(state.map.table[i], sstate.map.table)


# --- (v) BatchedOdometryRunner ---------------------------------------------

def _as_runs(seqs):
    return [{"frames": s["frames"], "rel_odometry": s["rel_odometry"]}
            for s in seqs]


def test_batched_odometry_runner_matches_jax(small_sequences):
    seqs = _as_runs(small_sequences[:2])
    mesh = make_mesh(data=1, map=1, devices=jax.devices()[:1])
    jres = JRunner(SMALL, batch=2, mesh=mesh).run(seqs)
    cfg = _port_cfg(SMALL)
    stepped = BatchedOdometryRunner(cfg, batch=2, device=CPU).run(seqs)
    device = BatchedOdometryRunner(cfg, batch=2, device=CPU).run_device(seqs)
    for i in range(2):
        assert len(stepped[i]) == len(device[i]) == NUM_FRAMES
        # JAX's own bound, tests/test_parallel.py:194
        assert ate_rmse(jres[i], stepped[i], align=False) < 5e-3
        assert ate_rmse(jres[i], device[i], align=False) < 5e-3
        assert ate_rmse(stepped[i], device[i], align=False) < 5e-3


def test_batched_odometry_runner_gate_and_limits(small_sequences):
    seqs = _as_runs([small_sequences[0], small_sequences[2]])
    cfg = _port_cfg(SMALL).replace(gn_backend="cuda")
    norms = np.array([np.linalg.norm(se3_log(np.asarray(r, np.float64)))
                      for r in small_sequences[0]["rel_odometry"]])
    # a gate in the widest gap among the middle moving frames: far from
    # every value, where the host's float64 and the device's float32 agree
    s = np.sort(norms[norms > 1e-3])
    i = len(s) // 4 + int(np.argmax(np.diff(s)[len(s) // 4:
                                               3 * len(s) // 4]))
    gate = float(0.5 * (s[i] + s[i + 1]))
    for how in ("run", "run_device"):
        runner = BatchedOdometryRunner(cfg, batch=2, stationary_gate=gate,
                                       device=CPU)
        poses = np.asarray(getattr(runner, how)(seqs)[0])
        prev = np.concatenate([np.eye(4)[None], poses[:-1]])
        moved = np.abs(poses - prev).max(axis=(1, 2)) > 0
        np.testing.assert_array_equal(moved, norms > gate, err_msg=how)
        assert moved.any() and not moved.all()
    one = BatchedOdometryRunner(cfg, batch=1, device=CPU)
    for call in (one.run, one.run_device):
        with pytest.raises(ValueError, match="2 sequences"):
            call(seqs)
    with pytest.raises(ValueError, match="2 sequences"):
        one.step([f for f, _ in seqs[0]["frames"][:2]],
                 seqs[0]["rel_odometry"][:2])


# --- (vi) batched states across packages -----------------------------------

def _jax_arrays(state):
    return (np.asarray(state.pose), np.asarray(state.map.table),
            np.asarray(state.threshold.odom_sse),
            np.asarray(state.threshold.num_samples))


def test_batched_state_round_trip(jax_batched):
    jfinal, _, _ = jax_batched
    for jstate in (joffline.init_batched_state(CFG, 3), jfinal):
        arrays = _jax_arrays(jstate)
        state = state_from_numpy(*arrays, bucket_slots=CFG.max_probes,
                                 device=CPU)
        assert state.map.table.shape[0] == 3 and state.pose.shape == (3, 4, 4)
        for a, b in zip(state_to_numpy(state), arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    fresh = state_to_numpy(toffline.init_batched_state(_port_cfg(CFG), 3,
                                                       device=CPU))
    for a, b in zip(fresh, _jax_arrays(joffline.init_batched_state(CFG, 3))):
        np.testing.assert_array_equal(a, b)
