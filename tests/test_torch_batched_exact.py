"""Port vs JAX: the reference-exact registration modes under a batch axis.

JAX runs the exact modes under ``vmap``, where each ``lax.cond`` becomes a
per-row select.  Where any of a batched frame's (B,) fallback flags is set,
the port runs the full-27 loop on the whole batch and takes its rows where
the flag is set (eagerly, as here, after one read-back of the flags).
Here the port's batched runner against JAX's (the full-27 and pruned
loops: JAX's certified branch needs the Pallas kernel), and each row of
the port's batched certified and pruned drives against that drive's own
``run_offline``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu import offline as joffline
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.models import pipeline as tpipe
from kinematic_icp_tpu_torch.ops import gn, registration
from kinematic_icp_tpu_torch.utils import synthetic
from kinematic_icp_tpu_torch.utils.evaluation import ate_rmse

# pytest-xdist runs several workers on the same cores: one intra-op
# thread each keeps these small tensors from oversubscribing them
torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_torch_pipeline.py's drive configuration, reference-exact
EXACT = JConfig(max_points=1024, max_downsampled=1024, max_source=512,
                map_capacity=4096, voxel_size=1.0, max_range=15.0,
                max_probes=4, deskew=True, neighbor_candidates=27,
                exact_gn_reassociation=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
NUM_FRAMES = 8
#: the first drive's length (the batch pads it with stationary frames)
SHORT = 5
#: frames the port and JAX agree on to 1e-5 (tests/test_torch_pipeline.py
#: :242); over the whole window they agree by ATE, XLA's fused
#: multiply-adds apart
CLOSE_FRAMES = 3
PRUNED = dict(exact_prune_candidates=14)


def _port_cfg(jcfg, **kw):
    return Config.from_dict(dataclasses.asdict(jcfg)).replace(**kw)


@pytest.fixture(scope="module")
def sequences():
    """Three drives (tests/test_parallel.py's seeds), the first cut to
    SHORT frames."""
    seqs = [synthetic.make_sequence(NUM_FRAMES, world_seed=s,
                                    traj_seed=s + 10, noise_seed=s + 20,
                                    lidar=synthetic.LidarModel(**LIDAR))
            for s in range(3)]
    seqs[0] = dict(seqs[0], frames=seqs[0]["frames"][:SHORT],
                   rel_odometry=seqs[0]["rel_odometry"][:SHORT])
    return seqs


@pytest.fixture(scope="module")
def port_batched(sequences):
    """The port's batched runner over the drives under a configuration:
    its outputs and the full-27 fallback loops it ran (the batched frames
    whose fallback flags have some row set, read from each registration's
    ``exact_fallback``), once a configuration."""
    runs = {}

    def run(cfg):
        if cfg not in runs:
            arrays = toffline.pad_batch(sequences, cfg)
            runner = toffline.make_batched_sequence_runner(cfg, device=CPU)
            flags = []
            motion = registration.compute_robot_motion

            def spy(*args, **kw):
                pose, debug = motion(*args, **kw)
                if debug.exact_fallback is not None:
                    flags.append(debug.exact_fallback.clone())
                return pose, debug

            with pytest.MonkeyPatch.context() as patch:
                patch.setattr(registration, "compute_robot_motion", spy)
                out = runner(
                    toffline.init_batched_state(cfg, len(sequences),
                                                device=CPU),
                    *(torch.from_numpy(a) for a in arrays[:4]), torch.eye(4),
                    torch.from_numpy(arrays[4]))
            runs[cfg] = out, sum(bool(f.any()) for f in flags)
        return runs[cfg]

    return run


@pytest.mark.parametrize("mode", [{}, PRUNED], ids=["full_27", "pruned"])
def test_batched_exact_runner_matches_jax(sequences, port_batched, mode):
    """JAX's batched runner (its XLA loop on the CPU) against the port's
    loop lowering: overflow and fallback counts bit-equal, poses within
    1e-5 over the first frames and 5 mm ATE over the window."""
    jcfg = EXACT.replace(**mode)
    arrays = toffline.pad_batch(sequences, _port_cfg(jcfg))
    _, jposes, jover, jfall = joffline.make_batched_sequence_runner(jcfg)(
        joffline.init_batched_state(jcfg, 3),
        *(jnp.asarray(a) for a in arrays[:4]), jnp.eye(4),
        jnp.asarray(arrays[4]))
    (_, poses, over, fall, _), _ = port_batched(
        _port_cfg(jcfg, gn_backend="torch"))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    np.testing.assert_array_equal(fall.numpy(), np.asarray(jfall))
    jposes, poses = np.asarray(jposes), poses.numpy()
    np.testing.assert_allclose(poses[:CLOSE_FRAMES], jposes[:CLOSE_FRAMES],
                               atol=1e-5, rtol=0)
    for i, s in enumerate(sequences):
        f = len(s["frames"])
        assert ate_rmse(list(jposes[:f, i]), list(poses[:f, i]),
                        align=False) < 5e-3
    if mode:  # the certificate failed somewhere, not everywhere
        assert 0 < int(fall.sum()) < 3 * NUM_FRAMES


def _spy_solves(monkeypatch):
    """Record each GN solve's batch and certificate flags."""
    calls = []
    solve = gn.gn_solve

    def spy(*args, **kw):
        out = solve(*args, **kw)
        calls.append((tuple(out[0].shape), kw.get("check_crossing", False),
                      out[4].clone()))
        return out

    monkeypatch.setattr(gn, "gn_solve", spy)
    return calls


@pytest.mark.parametrize("mode", [dict(gn_backend="cuda"),
                                  dict(gn_backend="torch", **PRUNED)],
                         ids=["certified", "pruned"])
def test_batched_rows_equal_run_offline(sequences, port_batched, mode,
                                        monkeypatch):
    """Each row of the batched drive is bit-equal to its drive's own
    ``run_offline`` (poses, final map, overflow) with the same fallback
    count; the batch mixes rows that fall back with rows that do not.
    Certified: one ``check_crossing`` solve of all rows a batched frame
    (the kernel's plain version on CPU tensors), and the full-27 loop runs
    on exactly the batched frames where some row crossed."""
    cfg = _port_cfg(EXACT, **mode)
    calls = _spy_solves(monkeypatch)
    (state, poses, over, fall, _), loops = port_batched(cfg)
    fall = fall.numpy()
    if mode["gn_backend"] == "cuda":
        assert [c[:2] for c in calls] == [((3, 4, 4), True)] * NUM_FRAMES
        assert loops == sum(bool(c[2].any()) for c in calls)
    assert 0 < loops < NUM_FRAMES
    assert fall.max() > 0 and fall.min() == 0, fall
    calls.clear()
    for i, s in enumerate(sequences):
        single, sstate, stats = toffline.run_offline(
            s["frames"], s["rel_odometry"], cfg, device=CPU,
            return_stats=True)
        got = poses[:len(single), i].numpy().astype(np.float64)
        np.testing.assert_array_equal(got, single)
        assert torch.equal(state.map.table[i], sstate.map.table)
        np.testing.assert_array_equal(over[i].numpy(), stats["overflow"])
        assert fall[i] == stats["exact_fallback_frames"]
    # the short drive holds its last pose over the padding frames
    for f in range(SHORT, NUM_FRAMES):
        assert torch.equal(poses[f, 0], poses[SHORT - 1, 0])


def test_batched_pruned_equals_batched_full_loop(port_batched):
    """Pruned exact under a batch equals the batched full-27 loop bit for
    bit, as it does unbatched."""
    cfg = _port_cfg(EXACT, gn_backend="torch")
    pruned, _ = port_batched(cfg.replace(**PRUNED))
    full, loops = port_batched(cfg)
    assert torch.equal(pruned[1], full[1])
    assert torch.equal(pruned[0].map.table, full[0].map.table)
    # the plain loop has no certificate
    assert not full[3].any() and loops == 0

