"""The map axis's all-reduce over peer memory (``parallel.peer``), on the
CPU: its plain version and where the sharded path takes it.

The kernel (``csrc/peer_reduce.cu``) runs only on a card: the card tests
(``tests/test_torch_kernels.py``) hold it to ``peer.reference`` at 1, 2 and
4 ranks on one card and inside a captured IF node.  Here: the plain
version combines in rank order (float sums are not associative, and every
rank must get the same bits), JAX's ``psum`` and ``pmin`` on the same parts
agree with it, and a gloo mesh reduces through ``torch.distributed`` with
no peer group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kinematic_icp_tpu_torch.parallel import make_mesh, mesh as tmesh, peer
from kinematic_icp_tpu_torch.parallel import sharded

torch.set_num_threads(1)


def _parts(rng, size, dtype, n):
    if dtype == np.int32:
        return [rng.integers(-2**30, 2**30, n, dtype=np.int32)
                for _ in range(size)]
    return [rng.normal(0, 1e3, n).astype(dtype) for _ in range(size)]


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("dtype,op", [(np.float32, "SUM"),
                                      (np.float64, "SUM"),
                                      (np.int32, "SUM"), (np.int32, "MIN")])
def test_reference_combines_in_rank_order(size, dtype, op):
    """``reference`` is a left fold over the ranks in rank order (so the
    same bits on every rank), and equals JAX's ``psum`` / ``pmin`` over a
    mapped axis of the same parts within float rounding (exactly for the
    integers; JAX on the CPU has no float64 here)."""
    rng = np.random.default_rng(size)
    parts = _parts(rng, size, dtype, 1000)
    got = peer.reference([torch.from_numpy(p) for p in parts],
                         getattr(dist.ReduceOp, op)).numpy()
    want = parts[0].copy()
    for p in parts[1:]:
        want = want + p if op == "SUM" else np.minimum(want, p)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == dtype
    if dtype == np.float64:  # JAX runs in float32 here
        return
    combine = jax.lax.psum if op == "SUM" else jax.lax.pmin
    jgot = np.asarray(jax.vmap(lambda x: combine(x, "r"), axis_name="r")(
        jnp.asarray(np.stack(parts))))
    for row in jgot:
        if dtype == np.int32:
            np.testing.assert_array_equal(row, got)
        else:  # XLA may add in another order
            np.testing.assert_allclose(row, got, rtol=1e-5, atol=1e-3)


def test_reference_refuses_other_ops():
    with pytest.raises(ValueError, match="peer all-reduce"):
        peer.reference([torch.ones(3)], dist.ReduceOp.MAX)


def test_gloo_mesh_reduces_without_a_peer_group():
    """A gloo map group has no peer group, and a map group of one rank
    reduces nothing: ``_all_reduce`` hands its input back untouched, in a
    conditional body too, and counts nothing on the host (the GN loop's
    collectives are counted on the device by a caller that asks)."""
    from kinematic_icp_tpu_torch.utils import cuda_graph

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, "cpu")
        group = mesh.get_group("map")
        assert tmesh.peer_group(group) is None
        before = sharded.COLLECTIVES
        t = torch.arange(6.0)
        assert sharded._all_reduce(t, dist.ReduceOp.SUM, group) is t
        assert torch.equal(t, torch.arange(6.0))
        cuda_graph.when(torch.tensor(True), lambda: sharded._all_reduce(
            t, dist.ReduceOp.MIN, group))
        assert torch.equal(t, torch.arange(6.0))
        assert sharded.COLLECTIVES == before
    finally:
        tmesh.shutdown_distributed()


#: four cards of one host, their UUIDs by index
HOST = ["GPU-a", "GPU-b", "GPU-c", "GPU-d"]


def _every_pair(i, j):
    return True


@pytest.mark.parametrize("cards,rank", [
    (HOST, 0), (HOST, 3), (["GPU-b", "GPU-d"], 1),
    (["GPU-a", "GPU-a"], 1)])
def test_ranks_on_one_host_with_peer_access_are_reachable(cards, rank):
    """Every rank's card on this host, each pair with peer access (or two
    ranks on one card, which need none): nothing to refuse."""
    assert peer.unreachable(cards, rank, HOST, _every_pair) is None


def test_a_rank_on_another_host_is_refused():
    """A card this process cannot see is on another host (or hidden from
    it): CUDA IPC cannot map its memory, and the rank says which."""
    why = peer.unreachable(["GPU-a", "GPU-x"], 0, HOST, _every_pair)
    assert "rank 1" in why and "another host" in why


def test_cards_without_peer_access_are_refused():
    """Two cards of one host without peer access between them (as
    ``cudaDeviceCanAccessPeer`` says): refused, naming both cards; a third
    card that has access is not named."""
    blocked = {(0, 2), (2, 0)}
    why = peer.unreachable(["GPU-a", "GPU-b", "GPU-c"], 0, HOST,
                           lambda i, j: (i, j) not in blocked)
    assert "card 0" in why and "card 2" in why and "rank 2" in why
    assert peer.unreachable(["GPU-a", "GPU-b"], 0, HOST,
                            lambda i, j: (i, j) not in blocked) is None


def test_attach_refuses_on_every_rank_before_mapping(monkeypatch):
    """``attach`` checks every rank's reach before it maps anything, and a
    refusal on any rank raises on every rank with the limit named (here a
    one-rank gloo group whose card is not on this host)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(peer, "_card_uuid",
                        {0: "GPU-a"}.__getitem__)
    monkeypatch.setattr(peer, "make_region", lambda device: pytest.fail(
        "mapped before the check"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        monkeypatch.setattr(peer, "unreachable",
                            lambda *a: "rank 0's card is elsewhere")
        with pytest.raises(RuntimeError, match="share one host"):
            peer.attach(dist.group.WORLD, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
