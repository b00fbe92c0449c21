"""The map axis's all-reduce over peer memory (``parallel.peer``), on the
CPU: its plain version, its chunks, its launch geometry, and the route a
mesh's map axis takes.

The kernel (``csrc/peer_reduce.cu``) runs only on a card: the card tests
(``tests/test_torch_kernels.py``) hold it to ``peer.reference`` at 1, 2 and
4 ranks on one card, beyond a slot, and inside a captured IF node.  Here:
the plain version combines in rank order (float sums are not associative,
and every rank must get the same bits), JAX's ``psum`` and ``pmin`` on the
same parts agree with it, a reduction beyond a slot runs in slot-sized
chunks with the same bits, the launch geometry the kernel follows (a grid
fixed per group that keeps every CTA of the ranks sharing a card resident,
tiles owned by CTA and by reducing rank whatever the size, the one-shot /
two-shot choice from bytes and ranks alone), a gloo mesh reduces through
``torch.distributed`` with no peer group, and ``make_mesh`` routes a map
group whose ranks cannot map each other's memory to "nccl" ("auto") or
refuses it ("peer").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kinematic_icp_tpu_torch.parallel import (make_mesh, map_route,
                                              mesh as tmesh, peer, sharded)

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


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("slots", [0.25, 1, 2.5, 3.1])
def test_chunks_cover_a_reduction_in_order_a_slot_at_most(dtype, slots):
    """A reduction of any size runs as slot-sized launches: the chunks
    cover its elements in order, none past a slot, and the plain version
    over the chunks is the plain version over the whole, bit for bit (each
    element combines the ranks' parts alone, in rank order)."""
    size = np.dtype(dtype).itemsize
    n = int(slots * peer.SLOT_BYTES / size) + (7 if slots > 3 else 0)
    got = peer.chunks(n, size)
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(0 < (b - a) * size <= peer.SLOT_BYTES for a, b in got)
    assert len(got) == -(-n * size // peer.SLOT_BYTES)
    assert peer.chunks(0, size) == []
    rng = np.random.default_rng(n)
    for op in (dist.ReduceOp.SUM, dist.ReduceOp.MIN):
        if op == dist.ReduceOp.MIN and dtype != np.int32:
            continue
        parts = [torch.from_numpy(p) for p in _parts(rng, 3, dtype, n)]
        whole = peer.reference(parts, op)
        pieces = torch.cat([peer.reference([p[a:b] for p in parts], op)
                            for a, b in got])
        assert torch.equal(whole.view(torch.uint8), pieces.view(torch.uint8))


#: an H100's SMs times the kernel's blocks an SM (512 threads a CTA)
H100_CTAS = 132 * 4


@pytest.mark.parametrize("capacity", [H100_CTAS, 132 * 2, 132, 7, 1])
@pytest.mark.parametrize("sharing", [1, 2, 3, 4, 32])
def test_grid_keeps_every_cta_of_a_card_resident(capacity, sharing):
    """A rank's grid times the ranks that share its card fits the card's
    resident CTAs (a CTA spins on its peers' CTAs, which must be running),
    at most ``MAX_CTAS``, at least one CTA (a card too small for one CTA
    a rank cannot keep all of them resident, and one is what is left)."""
    g = peer.grid(capacity, sharing)
    assert 1 <= g <= peer.MAX_CTAS
    if capacity >= sharing:
        assert g * sharing <= capacity
        assert (g + 1) * sharing > capacity or g == peer.MAX_CTAS
    assert peer.grid(H100_CTAS, 1) == peer.MAX_CTAS
    assert peer.grid(H100_CTAS, 4) == 132


@pytest.mark.parametrize("cards", [
    ["GPU-a", "GPU-b", "GPU-c", "GPU-d"], ["GPU-a"] * 4,
    ["GPU-a", "GPU-a", "GPU-b", "GPU-c"], ["GPU-a", "GPU-b"] * 2])
def test_group_grid_is_one_grid_that_fits_every_card(cards):
    """The group's grid is a function of the gathered cards and capacities
    alone (every rank holds the same lists, so every rank takes the same
    grid, and a tile's CTA is the same on every rank); on each card, its
    ranks' CTAs together fit, cards of other capacities too."""
    capacities = [H100_CTAS - 8 * r for r in range(len(cards))]
    g = peer.group_grid(cards, capacities)
    for card, cap in zip(cards, capacities):
        assert g * cards.count(card) <= cap
    assert g == min(peer.grid(c, cards.count(card))
                    for card, c in zip(cards, capacities))
    if len(set(cards)) == len(cards):
        assert g == min(peer.MAX_CTAS, min(capacities))


@pytest.mark.parametrize("grid", [1, 5, 132, peer.MAX_CTAS])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_tile_ownership_does_not_depend_on_the_size(grid, itemsize):
    """Byte ``b`` of a reduction lies in the same tile, of the same CTA,
    folded (two-shot) by the same rank, whatever the reduction's size, so
    CTA c of each rank only ever meets CTA c of the others in a slot; and
    every tile of a launch belongs to a CTA the launch runs."""
    sizes = [1, 3, peer.TILE_BYTES // itemsize + 1,
             5 * peer.TILE_BYTES // itemsize,
             peer.SLOT_BYTES // itemsize]
    owners = {}
    for n in sizes:
        tiles = peer.tiles(n, itemsize)
        assert tiles == -(-n * itemsize // peer.TILE_BYTES)
        ctas = peer.ctas(n, itemsize, grid)
        assert ctas == min(grid, tiles)
        for b in range(0, n * itemsize, 997):
            t = b // peer.TILE_BYTES
            who = (peer.cta_of(t, grid), peer.reducer(t, grid, 4))
            assert owners.setdefault(b, who) == who, (b, n)
            assert who[0] < ctas
        # each CTA of the launch has a tile of it
        assert {peer.cta_of(t, grid) for t in range(tiles)} == set(
            range(ctas))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("grid", [1, 132, peer.MAX_CTAS])
def test_two_shot_folds_each_tile_on_one_rank_spread_over_the_ranks(m,
                                                                    grid):
    """In a two-shot launch each tile is folded by exactly one rank of the
    m, and the ranks share the folds: over a slot's tiles their counts
    differ by at most a CTA's rounds (the tiles of one CTA rotate over the
    ranks, and so do the CTAs' first tiles)."""
    tiles = peer.SLOT_BYTES // peer.TILE_BYTES
    counts = [0] * m
    for t in range(tiles):
        r = peer.reducer(t, grid, m)
        assert 0 <= r < m
        counts[r] += 1
    assert sum(counts) == tiles
    assert max(counts) - min(counts) <= -(-tiles // grid) + 1
    assert min(counts) > 0


@pytest.mark.parametrize("m", [1, 2, 3, 4, 32])
def test_algorithm_is_one_shot_when_small_and_on_two_ranks(m):
    """The choice is a function of a launch's bytes and the group's ranks
    alone, so every rank picks alike: one-shot up to
    ``ONE_SHOT_MAX_BYTES``, and always on one or two ranks (where two-shot
    moves no fewer bytes); two-shot above it on more ranks."""
    small, big = peer.ONE_SHOT_MAX_BYTES, peer.ONE_SHOT_MAX_BYTES + 4
    assert peer.algorithm(4, m) == "one_shot"
    assert peer.algorithm(small, m) == "one_shot"
    assert peer.algorithm(big, m) == ("one_shot" if m <= 2 else "two_shot")
    assert peer.algorithm(peer.SLOT_BYTES, m) == peer.algorithm(big, m)


#: reach lists (one entry a rank, as ``peer.reach`` gathers them): four
#: ranks that reach each other; two whose rank 1 cannot see rank 0's card
REACHED = [None, None, None, None]
CUT_OFF = [None, "rank 0's card GPU-x is on another host or not visible "
           "here"]


@pytest.mark.parametrize("why,auto", [(REACHED, "peer"), (CUT_OFF, "nccl"),
                                      ([None], "peer")])
def test_route_decided_alike_from_the_gathered_reach(why, auto):
    """The route is a function of the gathered list alone, so every rank,
    holding the same list, takes the same one: "auto" is "peer" where every
    rank reaches every other and "nccl" where any cannot; "nccl" stays
    "nccl"; "peer" raises where any rank cannot, naming it and the limit."""
    for _rank in range(len(why)):  # each rank holds the same list
        assert peer.route(list(why)) == auto
        assert peer.route(list(why), "nccl") == "nccl"
    if auto == "peer":
        assert peer.route(why, "peer") == "peer"
    else:
        with pytest.raises(RuntimeError) as refused:
            peer.route(why, "peer")
        assert "rank 1" in str(refused.value)
        assert "another host" in str(refused.value)
        assert "share one host" in str(refused.value)
    with pytest.raises(ValueError, match="map_reduce"):
        peer.route(why, "psum")


@pytest.fixture
def nccl_map_group(monkeypatch):
    """A world of two ranks seen by rank 0 whose map group says it is
    NCCL's: ``make_mesh(1, 2)`` takes its route decision as on two cards
    (the mesh itself is a one-rank gloo mesh, and nothing is mapped)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = tmesh.init_device_mesh("cpu", (1, 1),
                                  mesh_dim_names=("data", "map"))
    monkeypatch.setattr(tmesh, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(tmesh, "init_device_mesh", lambda *a, **kw: mesh)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(peer, "attach", lambda *a: pytest.fail(
        "mapped a region"))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_routes_an_unreachable_map_group_to_nccl(nccl_map_group,
                                                           monkeypatch):
    """On an NCCL map group whose rank 1 is on another host, "auto" maps
    nothing and takes the "nccl" route, where it used to raise; forced
    "peer" still raises, naming the rank and the limit, before mapping;
    forced "nccl" asks nothing of the group's reach."""
    asked = []

    def unreachable_reach(group, device=None):
        asked.append(group)
        return list(CUT_OFF)

    monkeypatch.setattr(peer, "reach", unreachable_reach)
    mesh = make_mesh(1, 2)
    assert map_route(mesh) == "nccl" and tmesh.map_reduction(mesh).peers is None
    assert len(asked) == 1 and tmesh._peers == []
    with pytest.raises(RuntimeError, match="rank 1.*another host"):
        make_mesh(1, 2, map_reduce="peer")
    assert map_route(make_mesh(1, 2, map_reduce="nccl")) == "nccl"
    assert len(asked) == 2
    with pytest.raises(ValueError, match="map_reduce"):
        make_mesh(1, 2, map_reduce="ring")


def test_make_mesh_takes_the_peer_route_where_every_rank_reaches(
        nccl_map_group, monkeypatch):
    """Where every rank reaches every other, "auto" maps the peer regions
    (``peer.attach``, given the gathered list) and reduces over them."""
    mapped = []
    monkeypatch.setattr(peer, "reach", lambda group, device=None: [None] * 2)
    monkeypatch.setattr(peer, "attach", lambda group, device, why:
                        mapped.append(why) or "regions")
    mesh = make_mesh(1, 2)
    try:
        assert map_route(mesh) == "peer"
        assert tmesh.map_reduction(mesh).peers == "regions"
        assert mapped == [[None, None]] and tmesh._peers == ["regions"]
    finally:
        tmesh._peers.clear()


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
        assert tmesh.map_reduction(mesh).peers is None
        assert map_route(mesh) == "none"
        axes = sharded._axes(mesh)
        before = sharded.COLLECTIVES
        t = torch.arange(6.0)
        assert sharded._all_reduce(t, dist.ReduceOp.SUM, axes) is t
        assert torch.equal(t, torch.arange(6.0))
        cuda_graph.when(torch.tensor(True), lambda: sharded._all_reduce(
            t, dist.ReduceOp.MIN, axes))
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
