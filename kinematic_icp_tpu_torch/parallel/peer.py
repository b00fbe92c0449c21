"""The map axis's all-reduce over peer memory, an NCCL mesh's "peer" route.

JAX reduces over the map axis with ``lax.psum`` and ``lax.pmin`` inside its
compiled ``while_loop``.  The port's captured frame holds the GN loop's
later trips and its re-associations in conditional graph nodes
(``utils.cuda_graph.when``), and NCCL's collectives cannot live in a
conditional body: on four H100s (NCCL 2.28.9) such a capture failed at
instantiation with "invalid argument" and held only with NCCL's
graph-mixing support off (``NCCL_GRAPH_MIXING_SUPPORT=0``, whose event
nodes a body refuses), a process-wide setting that drops NCCL's ordering
of captured against uncaptured launches (``PERF.md`` §6).  So a map
group whose cards can all map each other's memory reduces with the port's
own kernel (``csrc/peer_reduce.cu``), one plain kernel node a slot: each
rank copies its part into a region of its own device memory that every
rank of the group has mapped, waits at a barrier of flags in that memory,
and combines the group's parts in rank order (the same bits on every
rank).  A group that cannot (ranks on other hosts, cards without peer
access) takes the "nccl" route instead (``parallel.mesh.make_mesh``).

The launch geometry, as pure functions the kernel follows: a reduction's
bytes fall in tiles of ``TILE_BYTES``; tile ``t`` belongs to CTA
``cta_of(t, grid)`` on every rank whatever the reduction's size, so each
CTA barriers with the same CTA of the other ranks alone; the group's grid
(``grid``, ``group_grid``) is fixed when the group is made, so every CTA
of the ranks that share a card is resident at once; a launch runs
``ctas`` of them; ``algorithm`` picks one-shot or two-shot from the bytes
and the ranks alone (two-shot: tile ``t`` folded by rank ``reducer(t,
grid, m)``, then copied by the others).

``reach(group)`` gathers, over ``group``, why each rank cannot map every
other rank's region (``unreachable``); ``route`` decides a route from that
list alone, so every rank decides alike.  ``attach(group, device)`` makes
the rank's region and maps the others' (a collective over ``group``: the
64-byte IPC handles, the card UUIDs and each card's CTA capacity are
exchanged once, when the mesh is made); ``PeerGroup.all_reduce`` launches
the kernel, once a slot of the tensor (``chunks``), and counts each launch
in ``LAUNCHES``; ``PeerGroup.close`` unmaps the others' regions and
``PeerGroup.free`` frees the rank's own (after every rank's last
reduction: ``parallel.shutdown_distributed``).  ``reference`` is the
kernel's plain version: the parts of every rank combined in rank order.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.distributed as dist

#: a slot's bytes: the most one launch reduces (the packed keys of 1,048,576
#: queries, 4 bytes each); a larger reduction runs a launch a slot
SLOT_BYTES = 4 << 20
#: the kernel's threads a CTA, bytes a tile (a 16-byte vector a thread) and
#: most CTAs a rank (``csrc/peer_reduce.cu``; checked when it loads)
THREADS = 512
TILE_BYTES = THREADS * 16
MAX_CTAS = 512
#: the most bytes a launch reduces one-shot over more than two ranks; a
#: larger launch runs two-shot (``algorithm``).  Four ranks on four
#: H100s, int32 MIN: one-shot 15.8-15.9 µs at 512 KiB against two-shot's
#: 18.6-19.1, two-shot 22.2-22.5 at 1 MiB against 23.7-23.9
#: (``tools/sharded_scaling.py --peer-bench``; PERF.md §6)
ONE_SHOT_MAX_BYTES = 512 << 10
#: the routes ``route`` takes: "auto", or one forced
ROUTES = ("auto", "peer", "nccl")
#: the kernel's reductions by (dtype, op)
_KINDS = {(torch.float32, "sum"): 0, (torch.float64, "sum"): 1,
          (torch.int32, "sum"): 2, (torch.int32, "min"): 3}

#: kernel launches so far (a plain count, bumped where ``all_reduce``
#: launches or a capture records a launch; a replay adds nothing, and a
#: launch inside a conditional body is counted where it is captured)
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..ops import cuda_build

        lib = cuda_build.load("peer_reduce")
        lib.kicp_peer_region_bytes.restype = ctypes.c_size_t
        lib.kicp_peer_region_bytes.argtypes = [ctypes.c_size_t]
        lib.kicp_peer_geometry.restype = None
        lib.kicp_peer_geometry.argtypes = [ctypes.c_void_p] * 3
        for fn, args in (
                ("kicp_peer_blocks_per_sm", [ctypes.c_void_p]),
                ("kicp_peer_alloc", [ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_void_p]),
                ("kicp_peer_open", [ctypes.c_void_p, ctypes.c_void_p]),
                ("kicp_peer_close", [ctypes.c_void_p]),
                ("kicp_peer_free", [ctypes.c_void_p]),
                ("kicp_peer_all_reduce", [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_size_t, ctypes.c_int,
                    ctypes.c_int])):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        threads, tile, most = (ctypes.c_int(), ctypes.c_longlong(),
                               ctypes.c_int())
        lib.kicp_peer_geometry(ctypes.byref(threads), ctypes.byref(tile),
                               ctypes.byref(most))
        built = (threads.value, tile.value, most.value)
        if built != (THREADS, TILE_BYTES, MAX_CTAS):
            raise RuntimeError(f"csrc/peer_reduce.cu's geometry {built} is "
                               f"not peer.py's "
                               f"{(THREADS, TILE_BYTES, MAX_CTAS)}")
        _lib = lib
    return _lib


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _op_name(op) -> str:
    if op == dist.ReduceOp.SUM:
        return "sum"
    if op == dist.ReduceOp.MIN:
        return "min"
    raise ValueError(f"peer all-reduce: no {op}")


def reference(parts, op):
    """The kernel's plain version: ``parts`` (one tensor a rank, in rank
    order) combined element by element in rank order."""
    name = _op_name(op)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p if name == "sum" else torch.minimum(acc, p)
    return acc


def chunks(n: int, element_size: int):
    """(start, stop) element ranges that cover ``n`` elements of
    ``element_size`` bytes in order, each at most a slot."""
    per = SLOT_BYTES // element_size
    return [(i, min(i + per, n)) for i in range(0, n, per)]


def tiles(n: int, element_size: int) -> int:
    """The tiles (``TILE_BYTES`` each, the last one partial) that ``n``
    elements of ``element_size`` bytes span."""
    return -(-n * element_size // TILE_BYTES)


def cta_of(tile: int, grid: int) -> int:
    """The CTA that copies, folds and reads ``tile`` of every reduction on
    every rank of a group of ``grid`` CTAs: a function of the tile alone,
    so the same CTA for every size, and a CTA barriers only with its own
    index on the other ranks."""
    return tile % grid


def reducer(tile: int, grid: int, m: int) -> int:
    """The rank that folds ``tile`` in a two-shot launch over ``m`` ranks:
    its CTA's index plus its round (``tile // grid``), so the CTAs of one
    round and the rounds of one CTA both rotate over the ranks."""
    return (tile % grid + tile // grid) % m


def ctas(n: int, element_size: int, grid: int) -> int:
    """CTAs a launch of ``n`` elements runs: one a tile, at most ``grid``
    (the rest have no tile of it and sit out, on every rank alike)."""
    return min(grid, tiles(n, element_size))


def grid(capacity: int, sharing: int) -> int:
    """A rank's CTAs on a card that holds ``capacity`` of the kernel's CTAs
    at once (SMs times blocks an SM), shared by ``sharing`` ranks of the
    group: every CTA of every one of them resident at once (a CTA spins on
    its peers' CTAs, so a CTA that could not be scheduled would hang the
    rest), at most ``MAX_CTAS``."""
    return max(1, min(MAX_CTAS, capacity // sharing))


def group_grid(cards, capacities) -> int:
    """The grid of a group whose ranks sit on ``cards`` (a card UUID a
    rank, in rank order) holding ``capacities`` CTAs each: the least of
    each rank's ``grid`` over the ranks that share its card, so every rank
    takes the same one."""
    sharing = collections.Counter(cards)
    return min(grid(c, sharing[card]) for card, c in zip(cards, capacities))


def algorithm(nbytes: int, m: int) -> str:
    """A launch's algorithm from its bytes and the group's ranks alone (so
    every rank picks alike): "one_shot" (one barrier; each rank folds every
    rank's part) up to ``ONE_SHOT_MAX_BYTES`` and on two ranks or fewer,
    where two-shot moves no fewer bytes; "two_shot" (each tile folded by
    one rank, two barriers) above it."""
    return ("one_shot" if m <= 2 or nbytes <= ONE_SHOT_MAX_BYTES
            else "two_shot")


def capacity(device) -> int:
    """CTAs of the kernel the card ``device`` holds at once: its SMs times
    the fewest blocks an SM of any instance (the occupancy API)."""
    lib = _load()
    device = _card(device)
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        _check(lib.kicp_peer_blocks_per_sm(ctypes.byref(blocks)),
               "the peer kernel's occupancy query")
    return (torch.cuda.get_device_properties(device).multi_processor_count
            * blocks.value)


def make_region(device):
    """(base pointer, IPC handle bytes) of a new zeroed region on the card
    ``device``."""
    lib = _load()
    ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
    with torch.cuda.device(device):
        _check(lib.kicp_peer_alloc(lib.kicp_peer_region_bytes(SLOT_BYTES),
                                   ctypes.byref(ptr), handle),
               "allocating a peer region")
    return ptr.value, handle.raw


def _card(device):
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class PeerGroup:
    """The regions of a map group's ranks as this rank sees them:
    ``pointers`` (one a rank, its own at ``rank``; on ``device``), and the
    group's ``grid`` (``group_grid``, the same on every rank).
    ``imported`` are the ones this process mapped, ``owned`` the ones it
    allocated."""

    def __init__(self, device, rank, pointers, grid, owned, imported=()):
        self.device = _card(device)
        self.rank, self.size, self.grid = rank, len(pointers), grid
        self.pointers = torch.tensor(pointers, dtype=torch.int64,
                                     device=self.device)
        self.owned, self.imported = list(owned), list(imported)

    def all_reduce(self, t, op):
        """``t`` (contiguous, on the group's card) reduced over the group in
        place on the current stream, a launch a slot (``chunks``), each
        one-shot or two-shot (``algorithm``); returns it.  Every rank
        reduces the same number of elements, so every rank launches the
        same chunks by the same algorithm in the same order, and each
        launch reads and bumps its CTAs' epochs on the device (a replay
        stays in step with eager reductions over the same group)."""
        global LAUNCHES
        kind = _KINDS.get((t.dtype, _op_name(op)))
        if kind is None:
            raise ValueError(f"peer all-reduce: no {t.dtype} {op}")
        if t.device != self.device or not t.is_contiguous():
            raise ValueError(f"peer all-reduce: a contiguous tensor on "
                             f"{self.device}, got {t.device}")
        lib = _load()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        flat = t.view(-1)
        size = t.element_size()
        for start, stop in chunks(t.numel(), size):
            two_shot = algorithm((stop - start) * size,
                                 self.size) == "two_shot"
            _check(lib.kicp_peer_all_reduce(
                stream, flat[start:].data_ptr(), stop - start, kind,
                self.pointers.data_ptr(), self.size, self.rank, SLOT_BYTES,
                self.grid, int(two_shot)), "the peer all-reduce launch")
            LAUNCHES += 1
        return t

    def close(self):
        """Unmap the other ranks' regions (after every rank's last
        reduction; every rank closes before any rank frees)."""
        lib = _load()
        for ptr in self.imported:
            _check(lib.kicp_peer_close(ctypes.c_void_p(ptr)),
                   "unmapping a peer region")
        self.imported = []

    def free(self):
        """Free this rank's region (once every rank has closed)."""
        lib = _load()
        for ptr in self.owned:
            _check(lib.kicp_peer_free(ctypes.c_void_p(ptr)),
                   "freeing a peer region")
        self.owned = []


def local_groups(device, size: int):
    """``size`` ``PeerGroup``s over ``size`` regions on one card, one a
    rank, for the kernel's check on one card (each rank's reductions
    launched on a stream of its own, at once): the grid shared by
    ``size`` ranks."""
    regions = [make_region(device)[0] for _ in range(size)]
    g = grid(capacity(device), size)
    return [PeerGroup(device, r, regions, g, [regions[r]])
            for r in range(size)]


def unreachable(cards, rank: int, local, can_access):
    """Why the rank ``rank`` of a group cannot map every other rank's
    region, or None.  ``cards`` holds each rank's card UUID in group
    order, ``local`` the UUIDs of the cards this process sees (by index),
    ``can_access(i, j)`` whether card ``i`` can map card ``j``'s memory.
    Ranks that share a card need no peer access."""
    mine = local.index(cards[rank])
    for r, card in enumerate(cards):
        if card == cards[rank]:
            continue
        if card not in local:
            return (f"rank {r}'s card {card} is on another host or not "
                    f"visible here")
        j = local.index(card)
        if not can_access(mine, j):
            return f"card {mine} cannot map the memory of card {j} (rank {r})"
    return None


def _card_uuid(index: int) -> str:
    return str(torch.cuda.get_device_properties(index).uuid)


def reach(group, device=None):
    """Why each rank of ``group`` (one card a rank) cannot map every other
    rank's region (``unreachable``; None where it can), in rank order: the
    card UUIDs gathered over ``group`` and each rank's answer gathered
    again, so every rank holds the same list.  Every rank of ``group``
    calls it together."""
    device = _card(device)
    local = [_card_uuid(i) for i in range(torch.cuda.device_count())]
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    cards = [None] * size
    dist.all_gather_object(cards, local[device.index], group=group)
    why = [None] * size
    dist.all_gather_object(why, unreachable(
        cards, rank, local, torch.cuda.can_device_access_peer), group=group)
    return why


def route(why, asked: str = "auto") -> str:
    """The route of a map group's reductions from ``reach``'s list ``why``
    (the same on every rank, so every rank decides alike): "auto" takes
    "peer" where every rank reaches every other and "nccl" otherwise;
    "peer" raises, naming each rank that cannot and the limit, where any
    cannot; "nccl" is "nccl"."""
    if asked not in ROUTES:
        raise ValueError(f"map_reduce {asked!r}: one of {ROUTES}")
    refused = [f"rank {r}: {w}" for r, w in enumerate(why) if w]
    if asked == "nccl" or (asked == "auto" and refused):
        return "nccl"
    if refused:
        raise RuntimeError(
            "the peer route maps each rank's region with CUDA IPC, so the "
            "ranks of a map group must share one host and each pair of "
            "their cards must have peer access: " + "; ".join(refused))
    return "peer"


def attach(group, device, why=None) -> PeerGroup:
    """This rank's ``PeerGroup`` over ``group`` (a process group, one card
    a rank): its region made; the handles, card UUIDs and CTA capacities
    exchanged over ``group``, which fix the group's grid (``group_grid``);
    the other ranks' regions mapped.  Every rank of ``group`` calls it
    together.  First every rank checks that it can map every other rank's
    card (``reach``, or its list ``why`` where the caller has gathered
    it), and if any cannot, every rank raises, naming the limit, before
    anything is mapped."""
    device = _card(device)
    route(reach(group, device) if why is None else why, "peer")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    ptr, handle = make_region(device)
    shared = [None] * size
    dist.all_gather_object(shared, (_card_uuid(device.index), handle,
                                    capacity(device)), group=group)
    cards, handles, capacities = zip(*shared)
    lib = _load()
    pointers, imported = [], []
    with torch.cuda.device(device):
        for j, h in enumerate(handles):
            if j == rank:
                pointers.append(ptr)
                continue
            mapped = ctypes.c_void_p()
            _check(lib.kicp_peer_open(ctypes.create_string_buffer(h, 64),
                                      ctypes.byref(mapped)),
                   "mapping a peer region")
            pointers.append(mapped.value)
            imported.append(mapped.value)
    return PeerGroup(device, rank, pointers,
                     group_grid(cards, capacities), [ptr], imported)
