"""Port vs JAX: odometry checkpoints (one npz format for both packages)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinematic_icp_tpu import Config as JConfig
from kinematic_icp_tpu.models import pipeline as jpipe
from kinematic_icp_tpu.utils import checkpoint as jckpt
from kinematic_icp_tpu_torch import Config
from kinematic_icp_tpu_torch.convert import state_to_numpy
from kinematic_icp_tpu_torch.models import pipeline as tpipe
from kinematic_icp_tpu_torch.offline import run_offline
from kinematic_icp_tpu_torch.utils import checkpoint as tckpt
from kinematic_icp_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CPU = "cpu"
#: tests/test_aux.py:185-186
JCFG = JConfig(max_points=1024, max_downsampled=1024, max_source=512,
               map_capacity=1 << 10, max_range=50.0)
#: tests/test_aux.py:87-88
DRIVE = dict(max_points=4096, max_downsampled=4096, max_source=1024,
             map_capacity=1 << 13, max_range=60.0, deskew=True)
FRAMES = 12


def _frame(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-10, 10, (JCFG.max_points, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_states():
    """The JAX state after one and after two frames (one compiled step)."""
    step = jpipe.make_step(JCFG, donate=False)
    n = JCFG.max_points
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = 0.2
    states = [jpipe.init_state(JCFG)]
    for seed in (0, 1):
        s, _ = step(states[-1], jnp.asarray(_frame(seed)), jnp.zeros(n),
                    jnp.ones(n, bool), jnp.bool_(False), jnp.eye(4),
                    jnp.asarray(rel))
        states.append(s)
    return states[1], states[2], rel


def _port_step(state, seed, rel, cfg):
    n = cfg.max_points
    return tpipe.register_frame(
        state, torch.from_numpy(_frame(seed)), torch.zeros(n),
        torch.ones(n, dtype=torch.bool), torch.tensor(False), torch.eye(4),
        torch.from_numpy(rel), cfg)[0]


def _assert_same_state(tstate, jstate):
    pose, table, sse, n = state_to_numpy(tstate)
    np.testing.assert_array_equal(table, np.asarray(jstate.map.table))
    np.testing.assert_array_equal(pose, np.asarray(jstate.pose))
    assert float(sse) == float(jstate.threshold.odom_sse)
    assert float(n) == float(jstate.threshold.num_samples)
    assert tstate.map.bucket_slots == jstate.map.bucket_slots


def test_roundtrip_with_extra_and_config(tmp_path):
    cfg = Config.from_dict(dataclasses.asdict(JCFG)).replace(gn_backend="cuda")
    state = tpipe.init_state(cfg, device=CPU)
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = 0.2
    state = _port_step(state, 0, rel, cfg)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, state, cfg, extra={"frame": 1})
    restored, meta = tckpt.load_state(path, device=CPU)
    assert meta["extra"]["frame"] == 1
    assert meta["config"]["gn_backend"] == "pallas"  # under JAX's name
    assert tckpt.load_config(meta) == cfg
    for a, b in zip(state_to_numpy(restored), state_to_numpy(state)):
        np.testing.assert_array_equal(a, b)
    assert restored.pose.dtype == torch.float32
    # the restored state continues exactly as the original
    a = _port_step(restored, 1, rel, cfg)
    b = _port_step(state, 1, rel, cfg)
    for x, y in zip(state_to_numpy(a), state_to_numpy(b)):
        np.testing.assert_array_equal(x, y)


def test_float64_state_keeps_its_dtype(tmp_path):
    cfg = Config.from_dict(dataclasses.asdict(JCFG))
    state = tpipe.init_state(cfg, torch.float64, device=CPU)
    rel = np.eye(4)
    rel[0, 3] = 0.2
    state = _port_step(state, 0, rel, cfg)
    path = str(tmp_path / "f64.npz")
    tckpt.save_state(path, state)
    restored, meta = tckpt.load_state(path, device=CPU)
    assert "config" not in meta and tckpt.load_config(meta) is None
    assert restored.pose.dtype == restored.threshold.odom_sse.dtype \
        == torch.float64
    assert torch.equal(restored.pose, state.pose)
    assert torch.equal(restored.threshold.odom_sse, state.threshold.odom_sse)


def test_jax_checkpoint_restores_into_port(jax_states, tmp_path):
    one, two, rel = jax_states
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, one, JCFG, extra={"frame": 1})
    restored, meta = tckpt.load_state(path, device=CPU)
    _assert_same_state(restored, one)
    assert meta["extra"] == {"frame": 1}
    cfg = tckpt.load_config(meta)
    assert cfg == Config.from_dict(dataclasses.asdict(JCFG))
    # the port continues from JAX's state like the JAX step
    nxt = _port_step(restored, 1, rel, cfg)
    np.testing.assert_allclose(nxt.pose.numpy(), np.asarray(two.pose),
                               atol=1e-5)


def test_port_checkpoint_restores_into_jax(jax_states, tmp_path):
    one, _, _ = jax_states
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, one)
    state, _ = tckpt.load_state(path, device=CPU)
    cfg = Config.from_dict(dataclasses.asdict(JCFG)).replace(
        gn_backend="torch")
    out = str(tmp_path / "port.npz")
    tckpt.save_state(out, state, cfg, extra={"frame": 1})
    jstate, meta = jckpt.load_state(out)
    _assert_same_state(state, jstate)
    assert jckpt.load_config(meta) == JCFG.replace(gn_backend="xla")
    assert meta["extra"] == {"frame": 1}
    assert np.asarray(jstate.map.table).dtype == np.uint32


def test_checkpoint_chain_equals_uninterrupted():
    """Three segments, each resumed from the previous one's checkpoint,
    give the uninterrupted run's poses bit for bit (as
    tests/test_stress.py requires of the JAX package)."""
    import io

    seq = synthetic.make_sequence(FRAMES)
    cfg = Config(**DRIVE)
    poses, _ = run_offline(seq["frames"], seq["rel_odometry"], cfg,
                           extrinsic=seq["extrinsic"], device=CPU)
    stitched, state = [], None
    for start in range(0, FRAMES, 4):
        part, state = run_offline(seq["frames"][start:start + 4],
                                  seq["rel_odometry"][start:start + 4], cfg,
                                  extrinsic=seq["extrinsic"], state=state,
                                  device=CPU)
        stitched.append(part)
        buf = io.BytesIO()
        tckpt.save_state(buf, state, cfg)
        buf.seek(0)
        state, meta = tckpt.load_state(buf, device=CPU)
        assert tckpt.load_config(meta) == cfg
    np.testing.assert_array_equal(np.concatenate(stitched), poses)


def test_wrong_format_version_raises(tmp_path):
    cfg = Config.from_dict(dataclasses.asdict(JCFG))
    path = str(tmp_path / "v2.npz")
    tckpt.save_state(path, tpipe.init_state(cfg, device=CPU))
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta["format_version"] = 2
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="version 2"):
        tckpt.load_state(path, device=CPU)
    with pytest.raises(ValueError, match="version 2"):
        jckpt.load_state(path)
