"""The port's compiled step (``pipeline.make_step``) on the CPU.

Against JAX's ``make_step`` on the same inputs (the exact modes
included), against ``register_frame`` and the eager frame loop, and the
step's buffer protocol: donation, reuse by a later sequence, in-place
refills (``set_pose``, a checkpoint), and a frame with no host sync but
one read-back a branch point, which a CUDA graph capture needs.  On the
CPU each call runs the frame eagerly over the step's buffers; the card
tests (``tests/test_torch_kernels.py``) replay it as CUDA graphs.
"""

import dataclasses
import functools
import io
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu.models import pipeline as jpipe
from kinematic_icp_tpu.ops import pallas_gn
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch import offline as toffline
from kinematic_icp_tpu_torch.convert import state_to_numpy
from kinematic_icp_tpu_torch.models import make_step
from kinematic_icp_tpu_torch.models import pipeline as tpipe
from kinematic_icp_tpu_torch.server import LidarOdometryServer
from kinematic_icp_tpu_torch.utils import checkpoint, synthetic

torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_torch_pipeline.py's drive (__graft_entry__.py:66-70)
DRIVE_CFG = JConfig(max_points=1024, max_downsampled=1024, max_source=512,
                    map_capacity=4096, voxel_size=1.0, max_range=15.0,
                    max_probes=4, deskew=True)
LIDAR = dict(num_beams=256, num_rings=4, ring_angles_deg=(-10.0, -3.0, 0.0,
                                                          8.0))
FRAMES = 6
CFG = Config.from_dict(dataclasses.asdict(DRIVE_CFG))
#: the exact modes at a 60 m range, where the certificates fail on some
#: frames of the drive (the fallback runs)
EXACT = dict(neighbor_candidates=27, exact_gn_reassociation=True,
             max_range=60.0)
CERTIFIED = CFG.replace(gn_backend="cuda", **EXACT)
PRUNED = CFG.replace(gn_backend="torch", exact_prune_candidates=14, **EXACT)


@pytest.fixture(scope="module")
def seqs():
    return [synthetic.make_sequence(FRAMES, world_seed=s, traj_seed=s + 10,
                                    noise_seed=s + 20,
                                    lidar=synthetic.LidarModel(**LIDAR))
            for s in range(2)]


def _frames(cfg, seq):
    """(pts, ts, mask, has_ts, rels) of a sequence as CPU tensors."""
    return [torch.from_numpy(a) for a in
            toffline.pad_sequence(seq["frames"], seq["rel_odometry"], cfg)]


def _bits_equal(a, b):
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _states_equal(a, b):
    return all(_bits_equal(x, y) for x, y in
               zip(tpipe.state_tensors(a), tpipe.state_tensors(b)))


@pytest.mark.parametrize("gn_backend", ["torch", "cuda"])
def test_step_matches_jax_make_step(seqs, gn_backend):
    """The port's step against JAX's ``make_step(donate=False)`` over a
    short drive: overflow counters bit-equal every frame, poses within
    1e-5, and the map table bit-equal where both packages inserted the
    frame at the same pose (the first frame: an empty map returns the
    guess)."""
    cfg = CFG.replace(gn_backend=gn_backend)
    jstep = jpipe.make_step(DRIVE_CFG, donate=False)
    tstep = make_step(cfg, device=CPU)
    pts, ts, mask, has_ts, rels = _frames(cfg, seqs[0])
    jstate = jpipe.init_state(DRIVE_CFG)
    tstate = tpipe.init_state(cfg, device=CPU)
    for f in range(FRAMES):
        jstate, jout = jstep(jstate, *(jnp.asarray(a[f].numpy()) for a in
                                       (pts, ts, mask, has_ts)),
                             jnp.eye(4), jnp.asarray(rels[f].numpy()))
        tstate, tout = tstep(tstate, pts[f], ts[f], mask[f], has_ts[f],
                             torch.eye(4), rels[f])
        np.testing.assert_array_equal(tout.overflow.numpy(),
                                      np.asarray(jout.overflow))
        np.testing.assert_allclose(tstate.pose.numpy(),
                                   np.asarray(jstate.pose), atol=1e-5,
                                   rtol=0)
        if f == 0:
            np.testing.assert_array_equal(
                state_to_numpy(tstate)[1],
                np.asarray(jstate.map.table).view(np.uint32))
    assert np.linalg.norm(tstate.pose.numpy()[:3, 3]) > 1.0


def test_donation(seqs):
    """``donate=True`` returns the step's own buffers (the same tensors
    every call, the caller's old state not to be used again);
    ``donate=False`` returns copies and leaves the input state as it
    was; both give ``register_frame``'s bits."""
    pts, ts, mask, has_ts, rels = _frames(CFG, seqs[0])
    start = tpipe.init_state(CFG, device=CPU)
    start, _ = tpipe.register_frame(start, pts[0], ts[0], mask[0], has_ts[0],
                                    torch.eye(4), rels[0], CFG)
    args = [(pts[f], ts[f], mask[f], has_ts[f], torch.eye(4), rels[f])
            for f in (1, 2)]
    want1, out1 = tpipe.register_frame(start, *args[0], CFG)
    want2, _ = tpipe.register_frame(want1, *args[1], CFG)

    kept = tpipe.clone_state(start)
    copying = tpipe.Step(CFG, donate=False, device=CPU)
    s1, o1 = copying(start, *args[0])
    again, _ = copying(start, *args[0])
    assert _states_equal(start, kept)
    assert _states_equal(s1, want1) and _states_equal(again, want1)
    assert s1.pose.data_ptr() != again.pose.data_ptr()
    assert _bits_equal(o1.pose, out1.pose)

    donating = tpipe.Step(CFG, donate=True, device=CPU)
    d1, _ = donating(start, *args[0])
    d2, _ = donating(d1, *args[1])
    assert d2 is d1
    assert _states_equal(d2, want2)
    assert d2.map.table.data_ptr() == d1.map.table.data_ptr()
    assert make_step(CFG, device=CPU) is make_step(CFG, device=CPU)
    assert make_step(CFG, donate=False, device=CPU) is not make_step(
        CFG, device=CPU)


@pytest.mark.parametrize("batch", [1, 2])
def test_runner_on_the_step_bit_equal_to_eager_loop(seqs, batch):
    """The runner over the step against the eager frame loop, for one
    sequence and for B = 2: poses, overflow totals and the final state
    bit-equal; the returned state is the caller's, not the step's."""
    if batch == 1:
        arrays = _frames(CFG, seqs[0])
        state = tpipe.init_state(CFG, device=CPU)

        def runner(eager):
            return toffline.make_sequence_runner(CFG, CPU, eager=eager)
    else:
        arrays = [torch.from_numpy(a) for a in toffline.pad_batch(seqs, CFG)]
        state = toffline.init_batched_state(CFG, 2, device=CPU)

        def runner(eager):
            return toffline.make_batched_sequence_runner(CFG, CPU,
                                                         eager=eager)

    args = (*arrays[:4], torch.eye(4), arrays[4])
    eager = runner(True)(state, *args)
    stepped = runner(False)(state, *args)
    assert _states_equal(stepped[0], eager[0])
    for a, b in zip(stepped[1:], eager[1:]):
        assert _bits_equal(a, b)
    assert stepped[1].shape == (FRAMES, *((2,) if batch == 2 else ()), 4, 4)
    # a later run must not write into the state this run returned
    kept = tpipe.clone_state(stepped[0])
    runner(False)(state, *args)
    assert _states_equal(stepped[0], kept)


def test_second_sequence_reuses_the_cached_step(seqs):
    """A second sequence of the same shapes through the cached runner (its
    step and buffers reused) gives the bits of a fresh step."""
    runner = toffline.make_sequence_runner(CFG, CPU)
    assert runner is toffline.make_sequence_runner(CFG, CPU)
    ext = torch.eye(4)
    for seq in seqs:
        a = _frames(CFG, seq)
        runner(tpipe.init_state(CFG, device=CPU), *a[:4], ext, a[4])
    fresh = toffline._runner(CFG, torch.device(CPU), toffline.STATIONARY_GATE,
                             False, tpipe.Step(CFG, device=CPU))
    b = _frames(CFG, seqs[1])
    second = runner(tpipe.init_state(CFG, device=CPU), *b[:4], ext, b[4])
    first = fresh(tpipe.init_state(CFG, device=CPU), *b[:4], ext, b[4])
    assert _states_equal(second[0], first[0])
    assert _bits_equal(second[1], first[1])


def _serve(server, seq, frames):
    for i in frames:
        p, t = seq["frames"][i]
        server.register_frame(p, t, seq["rel_odometry"][i], stamp=0.1 * i)
    return np.asarray([p for _, p in server.poses_with_stamps])


def test_set_pose_and_checkpoint_refill_the_servers_buffers(seqs):
    """``set_pose`` and a restored checkpoint copy into the server's state
    buffers (the tensors its steps run over) instead of rebinding them; a
    resumed server continues bit-equal; a state of another dtype raises."""
    seq = seqs[0]
    a = LidarOdometryServer(CFG, extrinsic=seq["extrinsic"], device=CPU)
    _serve(a, seq, range(3))
    buf = io.BytesIO()
    checkpoint.save_state(buf, a.state, CFG)
    buf.seek(0)
    restored, _ = checkpoint.load_state(buf, device=CPU)

    b = LidarOdometryServer(CFG, extrinsic=seq["extrinsic"], device=CPU)
    ptrs = [t.data_ptr() for t in tpipe.state_tensors(b.state)]
    b.state = restored
    assert [t.data_ptr() for t in tpipe.state_tensors(b.state)] == ptrs
    assert _states_equal(b.state, a.state)
    np.testing.assert_array_equal(_serve(b, seq, range(3, FRAMES)),
                                  _serve(a, seq, range(3, FRAMES))[3:])

    seed = synthetic.planar_pose(1.0, -2.0, 0.3)
    b.set_pose(seed)
    assert [t.data_ptr() for t in tpipe.state_tensors(b.state)] == ptrs
    np.testing.assert_array_equal(b.pose, seed.astype(np.float32))
    assert b.local_map_pointcloud().shape == (0, 3)
    with pytest.raises(ValueError):
        b.state = tpipe.init_state(CFG, dtype=torch.float64, device=CPU)


@pytest.mark.parametrize("cfg", [
    CERTIFIED, PRUNED,
    CFG.replace(neighbor_candidates=27, exact_gn_reassociation=True,
                gn_backend="torch"),
    CFG.replace(gn_backend="torch")],
    ids=["certified", "pruned", "full_27_loop", "loop_lowering"])
def test_refused_configs_run_the_eager_loop(seqs, cfg, monkeypatch):
    """``make_step`` takes every single-device configuration, the exact
    modes whose frame reads its fallback flag back included: each against
    JAX's jitted ``make_step(donate=False)`` over a short drive (JAX's
    certified kernel in interpret mode), overflow bit-equal, poses within
    1e-5 and the fallback flags equal every frame; the runners and the
    server route through the step (the runner's bits are the eager
    loop's).  The name dates from when the step refused these
    configurations and the runners ran them on the eager loop."""
    monkeypatch.setattr(pallas_gn, "gn_solve",
                        functools.partial(pallas_gn.gn_solve, interpret=True))
    jcfg = JConfig(**cfg.to_jax_dict())
    jstep = jpipe.make_step(jcfg, donate=False)
    tstep = make_step(cfg, device=CPU)
    assert isinstance(tstep, tpipe.Step)
    pts, ts, mask, has_ts, rels = _frames(cfg, seqs[0])
    jstate = jpipe.init_state(jcfg)
    tstate = tpipe.init_state(cfg, device=CPU)
    flags = []
    for f in range(FRAMES):
        jstate, jout = jstep(jstate, *(jnp.asarray(a[f].numpy()) for a in
                                       (pts, ts, mask, has_ts)),
                             jnp.eye(4), jnp.asarray(rels[f].numpy()))
        tstate, tout = tstep(tstate, pts[f], ts[f], mask[f], has_ts[f],
                             torch.eye(4), rels[f])
        np.testing.assert_array_equal(tout.overflow.numpy(),
                                      np.asarray(jout.overflow))
        np.testing.assert_allclose(tstate.pose.numpy(),
                                   np.asarray(jstate.pose), atol=1e-5,
                                   rtol=0)
        if cfg in (CERTIFIED, PRUNED):
            flags.append(bool(tout.debug.exact_fallback))
            assert flags[-1] == bool(jout.debug.exact_fallback), f
        else:
            assert tout.debug.exact_fallback is None
    assert np.linalg.norm(tstate.pose.numpy()[:3, 3]) > 1.0

    a = _frames(cfg, seqs[0])
    args = (tpipe.init_state(cfg, device=CPU), *a[:4], torch.eye(4), a[4])
    runner = toffline.make_sequence_runner(cfg, CPU)
    assert isinstance(runner.step, tpipe.Step)
    routed = runner(*args)
    eager = toffline.make_sequence_runner(cfg, CPU, eager=True)(*args)
    for x, y in zip(routed[1:], eager[1:]):
        assert _bits_equal(x, y)
    if flags:
        assert 0 < int(routed[3]) <= sum(flags)
    server = LidarOdometryServer(cfg, extrinsic=seqs[0]["extrinsic"],
                                 device=CPU)
    assert np.isfinite(_serve(server, seqs[0], range(3))).all()
    assert [key[1] for key in server._calls] == [0]


#: aten ops that read a device value back to the host
_SYNCS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
          "unique_consecutive", "is_nonzero", "equal"}


class _HostTraffic(TorchDispatchMode):
    """Records the ops a CUDA graph capture refuses: a read-back to the
    host, or a tensor made from a host value (``lift_fresh``, as an
    indexed assignment of a Python scalar makes) used as an operand."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if name in ("lift_fresh", "lift_fresh_copy"):
            out._from_host = True
            return out
        operands = []
        for a in (*args, *kwargs.values()):
            operands.extend(a if isinstance(a, (list, tuple)) else [a])
        if name in _SYNCS or any(getattr(a, "_from_host", False)
                                 for a in operands if torch.is_tensor(a)):
            where = [ln for ln in traceback.format_stack()
                     if "kinematic_icp_tpu_torch" in ln]
            self.found.append((func.__name__, where[-1] if where else "?"))
        return out


@pytest.mark.parametrize("kw,branch_points", [
    ({}, 0), (dict(gn_backend="torch", gn_candidates_per_voxel=4), 0),
    (dict(deskew=False, neighbor_candidates=27, exact_gn_reassociation=True,
          gn_backend="torch"), 0),
    (dict(EXACT, gn_backend="cuda"), 1),
    (dict(EXACT, gn_backend="torch", exact_prune_candidates=14), 1)],
    ids=["kernel_branch", "loop", "full_27_loop", "certified", "pruned"])
@pytest.mark.parametrize("batch", [0, 2])
def test_frame_has_no_host_sync(seqs, kw, branch_points, batch):
    """A frame of every configuration the step takes, unbatched and
    batched, run eagerly, copies no host value in and reads nothing back
    but its branch points' flags (``cuda_graph.branch``), one read-back
    each: the exact modes' one branch point, none elsewhere."""
    _assert_host_traffic(seqs, kw, batch, ["_local_scalar_dense.default"]
                         * branch_points)


class _Capture:
    """Stands in for a static call's capture: counts the IF nodes (reading
    no predicate) and lets every body run on the current stream, as a
    capture records it."""

    def __init__(self):
        self.nodes = 0

    def begin_if(self, pred):
        self.nodes += 1

    def end_if(self):
        pass


@pytest.mark.parametrize("kw,nodes", [
    ({}, 18), (dict(gn_backend="torch", gn_candidates_per_voxel=4), 18),
    (dict(deskew=False, neighbor_candidates=27, exact_gn_reassociation=True,
          gn_backend="torch"), 18),
    (dict(EXACT, gn_backend="cuda"), 19),
    (dict(EXACT, gn_backend="torch", exact_prune_candidates=14), 37)],
    ids=["kernel_branch", "loop", "full_27_loop", "certified", "pruned"])
@pytest.mark.parametrize("batch", [0, 2])
def test_captured_frame_reads_nothing_back(seqs, kw, nodes, batch):
    """The same frames as a capture records them: no read-back and no
    host value at all; the exact modes' fallback, and the GN loop's 8
    later trips and 9 re-associations, as conditional nodes (two loops and
    the fallback's node under pruned exact; on CPU tensors the default
    registration is the loop)."""
    capture = _Capture()
    _assert_host_traffic(seqs, kw, batch, [], capture)
    assert capture.nodes == nodes


def _assert_host_traffic(seqs, kw, batch, reads, capture=None):
    """A frame under ``CFG.replace(**kw)`` (a batch of ``batch`` copies,
    or unbatched), run as ``capture`` records it if given, else eagerly,
    records exactly ``reads``, each a read-back in ``cuda_graph.branch``."""
    from kinematic_icp_tpu_torch.utils import cuda_graph

    cfg = CFG.replace(**kw)
    pts, ts, mask, has_ts, rels = _frames(cfg, seqs[0])
    state, _ = tpipe.register_frame(tpipe.init_state(cfg, device=CPU),
                                    pts[0], ts[0], mask[0], has_ts[0],
                                    torch.eye(4), rels[0], cfg)
    args = [pts[1], ts[1], mask[1], has_ts[1], rels[1],
            torch.tensor(True), torch.zeros(6)]
    if batch:
        state = tpipe.OdometryState(
            state.pose.expand(batch, 4, 4).clone(),
            tpipe.hashmap.MapState(state.map.table.expand(
                batch, *state.map.table.shape).clone(),
                state.map.bucket_slots),
            type(state.threshold)(*(t.expand(batch).clone()
                                    for t in state.threshold)))
        args = [a.expand(batch, *a.shape).clone() for a in args]
    cuda_graph._active = capture
    try:
        with _HostTraffic() as mode:
            tpipe.register_frame(state, *args[:4], torch.eye(4), args[4],
                                 cfg, active=args[5],
                                 rel_twist_in_lidar=args[6])
    finally:
        cuda_graph._active = None
    assert [name for name, where in mode.found
            if "cuda_graph.py" in where and "in branch" in where] == reads
    assert len(mode.found) == len(reads)


@pytest.mark.parametrize("upload", ["f32", "u16"])
def test_server_steps_have_no_host_sync(upload):
    """The server's blocking step and its chunk-scan step over their
    buffers: no read-back, no host value copied in."""
    server = LidarOdometryServer(CFG, upload=upload, stream_chunk=2,
                                 device=CPU)
    for rows in (0, 2):
        _, call = server._call(CFG.max_points, rows)
        with _HostTraffic() as mode:
            call()
        assert mode.found == []


def test_replays_redo_what_their_capture_recorded():
    """The counters a replay advances are registered by the modules that
    own them (``cuda_graph.replayed``), and a graph's recorded effects
    redo its capture's: the counters' increments added, the last values
    set again, whatever happened in between."""
    from kinematic_icp_tpu_torch.ops import gn
    from kinematic_icp_tpu_torch.parallel import sharded
    from kinematic_icp_tpu_torch.utils import cuda_graph

    assert set(cuda_graph._COUNTERS) == {
        (gn, "LAUNCHES"), (gn, "FRAMES"), (gn, "CROSSING_LAUNCHES"),
        (sharded, "COLLECTIVES")}
    assert cuda_graph._LATEST == [(gn, "LAST_CTAS")]
    saved = {**cuda_graph._counts(), **cuda_graph._latest()}
    try:
        gn.LAUNCHES, gn.LAST_CTAS, sharded.COLLECTIVES = 5, 3, 9
        gn.FRAMES = 4
        effects = cuda_graph._Effects()
        gn.LAUNCHES += 2
        sharded.COLLECTIVES += 1
        gn.LAST_CTAS = 7
        effects.end()
        cuda_graph._set({(gn, "LAUNCHES"): 0, (gn, "LAST_CTAS"): 1})
        effects.apply()
        effects.apply()
        assert (gn.LAUNCHES, gn.LAST_CTAS, sharded.COLLECTIVES,
                gn.FRAMES) == (4, 7, 12, 4)
        assert effects.added == {(gn, "LAUNCHES"): 2,
                                 (sharded, "COLLECTIVES"): 1}
    finally:
        cuda_graph._set(saved)
