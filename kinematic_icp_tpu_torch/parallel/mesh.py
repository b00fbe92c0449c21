"""Process groups and the (data, map) device mesh on ``torch.distributed``.

The system's two parallel axes, as in the JAX package:
  * ``data`` — independent sequences (each rank holds its rows of a batch),
  * ``map``  — each sequence's voxel hash-table buckets sharded over ranks,
    with summed 2-DoF normal equations and the packed-key minimum that
    picks each query's nearest neighbour across shards
    (``parallel.sharded``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one rank a process.  Start the processes with ``torchrun``
(``initialize_distributed()`` reads its environment) or pass the
coordinator's address, the process count and this process's index, and
leave the group with ``shutdown_distributed``.  Either axis may span hosts.

``make_mesh`` fixes how the map axis reduces, its route (``map_route``),
before the first frame, the same on every rank of a map group:
  * "peer": the port's kernel over peer memory (``parallel.peer``), which
    a conditional graph node can hold, so a captured frame's GN loop
    exits early on the device as JAX's ``while_loop`` does; its ranks
    share one host, with peer access between their cards;
  * "nccl": the group's own ``all_reduce`` (NCCL's; gloo's on a gloo
    group), captured in the frame's graph outside any conditional node,
    so the GN loop runs every trip, masked (NCCL's collectives cannot
    live in a conditional body); any map group, across hosts too;
  * "gloo": a gloo group's ``all_reduce``, the frame run eagerly;
  * "none": a map group of one rank, which reduces nothing.
"""

from __future__ import annotations

import datetime
import os
import weakref
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..runtime import resolve_device

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(seconds=120)

#: the live steps whose captured frames issue collectives of the default
#: group's ranks (``parallel.sharded``)
_captured = weakref.WeakSet()
#: every peer group mapped (``parallel.peer.PeerGroup``), freed by
#: ``shutdown_distributed``
_peers = []


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None):
    """Join the default process group (once per process).

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` rendezvous over TCP; without them torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) is read.
    ``backend`` ``None`` is "nccl" where CUDA is available and "gloo"
    otherwise; it is never swapped for another on failure.  On a CUDA
    machine the process takes the card ``LOCAL_RANK`` (torchrun's; else
    the rank) modulo the card count.  A collective that waits longer than
    ``TIMEOUT`` fails instead of hanging.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
        local_rank = process_id
    else:
        kw = dict(init_method="env://")
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        os.environ.get("RANK", "0")))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=TIMEOUT, **kw)


def track_captured(step):
    """Have ``shutdown_distributed`` free ``step``'s graphs (a
    ``pipeline.Step`` whose captured frames issue collectives)."""
    _captured.add(step)


class MapReduction(NamedTuple):
    """How a mesh's map axis reduces: its ``route`` ("peer", "nccl",
    "gloo" or "none") and, on "peer", this rank's ``peers``
    (``parallel.peer.PeerGroup``)."""
    route: str
    peers: object = None


def map_reduction(mesh) -> MapReduction:
    """The ``MapReduction`` ``make_mesh`` chose for ``mesh``."""
    try:
        return mesh._kicp_map_reduction
    except AttributeError:
        raise ValueError("a mesh made by parallel.make_mesh") from None


def map_route(mesh) -> str:
    """The route of ``mesh``'s map-axis reductions: "peer", "nccl", "gloo"
    or "none" (``make_mesh``)."""
    return map_reduction(mesh).route


def shutdown_distributed():
    """Leave the default process group: free the graphs of every captured
    frame that issues collectives first, then the peer regions of the
    meshes on the "peer" route (every rank unmaps the others' before any
    rank frees its own; the other routes mapped none), then
    ``destroy_process_group``.

    A captured NCCL frame holds its communicator, and NCCL's teardown waits
    for it: on four ranks ``destroy_process_group`` hangs while such a
    graph is alive.  A step released here cannot run again: its group is
    gone.
    """
    for step in list(_captured):
        step.release()
    _captured.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if _peers:
        dist.barrier()
        for peers in _peers:
            peers.close()
        dist.barrier()
        for peers in _peers:
            peers.free()
        _peers.clear()
    dist.destroy_process_group()


def make_mesh(data: int | None = None, map: int = 1, device_type=None,
              map_reduce: str = "auto"):
    """A (data, map) ``DeviceMesh`` over every rank of the default group.

    ``data=None`` puts the ranks ``map`` does not take on the data axis;
    ``data * map`` must equal the world size.  ``device_type`` ``None``
    means "cuda" (raises without a card); pass "cpu" for CPU tensors.

    ``map_reduce`` fixes the map axis's route (``map_route``), decided on
    every rank from the same gathered list, so every rank of a map group
    takes the same one:
      * "auto": on an NCCL map group of more than one rank, "peer" where
        every rank can map every other rank's memory
        (``parallel.peer.reach``: one host, peer access between the
        cards) and "nccl" otherwise; "gloo" on a gloo group, "none" on a
        group of one rank;
      * "peer": the peer regions mapped (``parallel.peer.attach``), on a
        group of one rank too; raises on every rank, naming the rank and
        the limit, where a rank cannot map them;
      * "nccl": the group's own ``all_reduce``, even on a group of one
        rank; no region is mapped.
    A route is never chosen after a failure: a mapping, capture or launch
    that fails raises.
    """
    from . import peer

    if map_reduce not in peer.ROUTES:
        raise ValueError(f"map_reduce {map_reduce!r}: one of {peer.ROUTES}")
    device_type = resolve_device(device_type).type
    n = dist.get_world_size()
    if data is None:
        if n % map:
            raise ValueError(f"{n} ranks do not divide by map={map}")
        data = n // map
    if data * map != n:
        raise ValueError(f"mesh {data}x{map} != {n} ranks")
    if map_reduce == "peer" and device_type != "cuda":
        raise ValueError("the peer route reduces CUDA tensors")
    mesh = init_device_mesh(device_type, (data, map),
                            mesh_dim_names=("data", "map"))
    group = mesh.get_group("map")
    if map_reduce == "auto" and map == 1:
        reduction = MapReduction("none")
    elif map_reduce == "auto" and dist.get_backend(group) != "nccl":
        reduction = MapReduction("gloo")
    elif map_reduce == "nccl":
        reduction = MapReduction("nccl")
    else:
        why = peer.reach(group)
        route = peer.route(why, map_reduce)
        reduction = MapReduction(route, peer.attach(group, None, why)
                                 if route == "peer" else None)
        if reduction.peers is not None:
            _peers.append(reduction.peers)
    mesh._kicp_map_reduction = reduction
    return mesh
