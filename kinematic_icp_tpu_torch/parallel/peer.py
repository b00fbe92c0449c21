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

``reach(group)`` gathers, over ``group``, why each rank cannot map every
other rank's region (``unreachable``); ``route`` decides a route from that
list alone, so every rank decides alike.  ``attach(group, device)`` makes
the rank's region and maps the others' (a collective over ``group``: the
64-byte IPC handles are exchanged once, when the mesh is made);
``PeerGroup.all_reduce`` launches the kernel, once a slot of the tensor
(``chunks``); ``PeerGroup.close`` unmaps the others' regions and
``PeerGroup.free`` frees the rank's own (after every rank's last
reduction: ``parallel.shutdown_distributed``).  ``reference`` is the
kernel's plain version: the parts of every rank combined in rank order.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

#: a slot's bytes: the most one launch reduces (the packed keys of 1,048,576
#: queries, 4 bytes each); a larger reduction runs a launch a slot
SLOT_BYTES = 4 << 20
#: the routes ``route`` takes: "auto", or one forced
ROUTES = ("auto", "peer", "nccl")
#: the kernel's reductions by (dtype, op)
_KINDS = {(torch.float32, "sum"): 0, (torch.float64, "sum"): 1,
          (torch.int32, "sum"): 2, (torch.int32, "min"): 3}

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..ops import cuda_build

        lib = cuda_build.load("peer_reduce")
        lib.kicp_peer_region_bytes.restype = ctypes.c_size_t
        lib.kicp_peer_region_bytes.argtypes = [ctypes.c_size_t]
        for fn, args in (
                ("kicp_peer_alloc", [ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_void_p]),
                ("kicp_peer_open", [ctypes.c_void_p, ctypes.c_void_p]),
                ("kicp_peer_close", [ctypes.c_void_p]),
                ("kicp_peer_free", [ctypes.c_void_p]),
                ("kicp_peer_all_reduce", [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_size_t])):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
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
    ``pointers`` (one a rank, its own at ``rank``; on ``device``).
    ``imported`` are the ones this process mapped, ``owned`` the ones it
    allocated."""

    def __init__(self, device, rank, pointers, owned, imported=()):
        self.device = _card(device)
        self.rank, self.size = rank, len(pointers)
        self.pointers = torch.tensor(pointers, dtype=torch.int64,
                                     device=self.device)
        self.owned, self.imported = list(owned), list(imported)

    def all_reduce(self, t, op):
        """``t`` (contiguous, on the group's card) reduced over the group in
        place on the current stream, a launch a slot (``chunks``); returns
        it.  Every rank reduces the same number of elements, so every rank
        launches the same chunks in the same order, and each launch reads
        and bumps the rank's epoch on the device (a replay stays in step
        with eager reductions over the same group)."""
        kind = _KINDS.get((t.dtype, _op_name(op)))
        if kind is None:
            raise ValueError(f"peer all-reduce: no {t.dtype} {op}")
        if t.device != self.device or not t.is_contiguous():
            raise ValueError(f"peer all-reduce: a contiguous tensor on "
                             f"{self.device}, got {t.device}")
        lib = _load()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        flat = t.view(-1)
        for start, stop in chunks(t.numel(), t.element_size()):
            _check(lib.kicp_peer_all_reduce(
                stream, flat[start:].data_ptr(), stop - start, kind,
                self.pointers.data_ptr(), self.size, self.rank, SLOT_BYTES),
                "the peer all-reduce launch")
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
    launched on a stream of its own, at once)."""
    regions = [make_region(device)[0] for _ in range(size)]
    return [PeerGroup(device, r, regions, [regions[r]]) for r in range(size)]


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
    a rank): its region made, the handles exchanged over ``group``, the
    other ranks' regions mapped.  Every rank of ``group`` calls it
    together.  First every rank checks that it can map every other rank's
    card (``reach``, or its list ``why`` where the caller has gathered
    it), and if any cannot, every rank raises, naming the limit, before
    anything is mapped."""
    device = _card(device)
    route(reach(group, device) if why is None else why, "peer")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    ptr, handle = make_region(device)
    handles = [None] * size
    dist.all_gather_object(handles, handle, group=group)
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
    return PeerGroup(device, rank, pointers, [ptr], imported)
