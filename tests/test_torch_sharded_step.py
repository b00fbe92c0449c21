"""The buffered map-sharded step against the eager one, on the CPU.

``parallel.sharded.make_sharded_step`` and ``make_sharded_sequence_runner``
run ``sharded_register_frame`` over buffers of their own (a
``pipeline.Step``), captured as a CUDA graph where the map group is NCCL's;
on a gloo group they run the same buffered protocol eagerly.  Here, on a
one-rank gloo group in this process, both hold to the eager frame
(``sharded_register_frame`` op by op) bit for bit: poses, overflow, the
final state and the collectives issued.  The (2, 2) gloo mesh's check runs
in ``tests/test_torch_sharded.py``'s worker processes; the NCCL capture in
the card tests (``tests/test_torch_kernels.py``).  ``shutdown_distributed``
frees the tracked steps' graphs before it leaves the group.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.models import pipeline
from kinematic_icp_tpu_torch.parallel import (make_mesh, mesh as tmesh,
                                              sharded, shutdown_distributed)
from kinematic_icp_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_torch_sharded.py's one-rank configuration and sensor
CFG = Config(max_points=1024, max_downsampled=1024, max_source=512,
             map_capacity=4096, voxel_size=1.0, max_range=15.0,
             max_probes=4, deskew=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
FRAMES = 6


def _one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def test_shutdown_releases_tracked_steps_then_leaves_the_group():
    """``shutdown_distributed`` releases every live tracked step (a
    captured NCCL frame holds its communicator), forgets them, and then
    destroys the default group; a gloo step is never tracked."""
    class Tracked:
        released = 0

        def release(self):
            self.released += 1

    _one_rank_group()
    steps = [Tracked(), Tracked()]
    for s in steps:
        tmesh.track_captured(s)
    gloo = sharded.make_sharded_step(CFG, make_mesh(1, 1, CPU))
    assert len(tmesh._captured) == 2 and gloo is not None
    shutdown_distributed()
    assert [s.released for s in steps] == [1, 1]
    assert len(tmesh._captured) == 0 and not dist.is_initialized()


@pytest.fixture(scope="module")
def one_rank():
    _one_rank_group()
    try:
        yield make_mesh(1, 1, CPU)
    finally:
        shutdown_distributed()


@pytest.fixture(scope="module")
def arrays():
    seqs = [synthetic.make_sequence(FRAMES, world_seed=s, traj_seed=s + 10,
                                    noise_seed=s + 20,
                                    lidar=synthetic.LidarModel(**LIDAR))
            for s in range(2)]
    pts, ts, mask, has_ts, rels = (torch.from_numpy(a) for a in
                                   toffline.pad_batch(seqs, CFG))
    return pts, ts, mask, has_ts, torch.eye(4), rels


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _states_same(a, b):
    return all(_same(x, y) for x, y in zip(pipeline.state_tensors(a),
                                           pipeline.state_tensors(b)))


CONFIGS = [CFG, CFG.replace(exact_gn_reassociation=True)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["cached", "exact"])
def test_buffered_step_bit_equal_to_eager_frame(one_rank, arrays, cfg):
    """``make_sharded_step`` (the step's own buffers, donated) against
    ``sharded_register_frame`` op by op, frame by frame: poses, overflow,
    the state after every frame and the collectives issued; on gloo the
    step captures nothing."""
    pts, ts, mask, has_ts, ext, rels = arrays
    active = torch.ones(2, dtype=torch.bool)
    step = sharded.make_sharded_step(cfg, one_rank)
    state = sharded.init_sharded_state(cfg, one_rank, 2)
    eager = pipeline.clone_state(state)
    for f in range(FRAMES):
        before = sharded.COLLECTIVES
        state, poses, overflow = step(state, pts[f], ts[f], mask[f],
                                      has_ts[f], ext, rels[f], active)
        stepped = sharded.COLLECTIVES - before
        eager, out = sharded.sharded_register_frame(
            eager, pts[f], ts[f], mask[f], has_ts[f], ext, rels[f], cfg,
            one_rank, active=active)
        assert stepped == sharded.COLLECTIVES - before - stepped > 0
        assert _same(poses, out.pose) and _same(overflow, out.overflow)
        assert _states_same(state, eager)
    assert np.linalg.norm(state.pose.numpy()[0, :3, 3]) > 1.0


@pytest.mark.parametrize("cfg", CONFIGS, ids=["cached", "exact"])
def test_buffered_runner_bit_equal_to_eager_runner(one_rank, arrays, cfg):
    """``make_sharded_sequence_runner`` on its step against its
    ``eager=True`` loop: poses, overflow totals and the final state
    bit-equal, the same collectives; the returned state is the caller's,
    and the gloo step replays no graph."""
    runs = {}
    for eager in (True, False):
        run = sharded.make_sharded_sequence_runner(cfg, one_rank,
                                                   eager=eager)
        before = sharded.COLLECTIVES
        runs[eager] = run(sharded.init_sharded_state(cfg, one_rank, 2),
                          *arrays), sharded.COLLECTIVES - before
        if eager:
            assert run.step is None
        else:
            assert not run.step.capture and run.step.pool is None
            assert [c.graphs for c in run.step.calls] == [0]
    (want, n_want), (got, n_got) = runs[True], runs[False]
    assert n_got == n_want > 0
    assert _states_same(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _same(a, b)
    kept = pipeline.clone_state(got[0])
    run(sharded.init_sharded_state(cfg, one_rank, 2), *arrays)
    assert _states_same(got[0], kept)
