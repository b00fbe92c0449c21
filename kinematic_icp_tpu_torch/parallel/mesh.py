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
leave the group with ``shutdown_distributed``.  On NCCL a map axis of
more than one rank reduces over peer memory (``parallel.peer``, mapped by
``make_mesh``), so that a captured frame can hold its reductions inside
conditional nodes; so its ranks must share one host, with peer access
between their cards (``make_mesh`` raises otherwise).  The data axis may
span hosts.
"""

from __future__ import annotations

import datetime
import os
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..runtime import resolve_device

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(seconds=120)

#: the live steps whose captured frames issue collectives of the default
#: group's ranks (``parallel.sharded``)
_captured = weakref.WeakSet()
#: the map groups' peer regions (``parallel.peer.PeerGroup``) by group name
_peers = {}


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


def peer_group(group):
    """The ``parallel.peer.PeerGroup`` a map ``group`` reduces over, or
    None (gloo, or a group of one rank, which reduces nothing)."""
    return _peers.get(group.group_name)


def shutdown_distributed():
    """Leave the default process group: free the graphs of every captured
    frame that issues collectives first, then the map groups' peer
    regions (every rank unmaps the others' before any rank frees its own),
    then ``destroy_process_group``.

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
        for peers in _peers.values():
            peers.close()
        dist.barrier()
        for peers in _peers.values():
            peers.free()
        _peers.clear()
    dist.destroy_process_group()


def make_mesh(data: int | None = None, map: int = 1, device_type=None):
    """A (data, map) ``DeviceMesh`` over every rank of the default group.

    ``data=None`` puts the ranks ``map`` does not take on the data axis;
    ``data * map`` must equal the world size.  ``device_type`` ``None``
    means "cuda" (raises without a card); pass "cpu" for CPU tensors.  On
    NCCL each map group of more than one rank maps its ranks' peer
    regions (``parallel.peer.attach``, which raises where a group spans
    hosts or two of its cards lack peer access).
    """
    device_type = resolve_device(device_type).type
    n = dist.get_world_size()
    if data is None:
        if n % map:
            raise ValueError(f"{n} ranks do not divide by map={map}")
        data = n // map
    if data * map != n:
        raise ValueError(f"mesh {data}x{map} != {n} ranks")
    mesh = init_device_mesh(device_type, (data, map),
                            mesh_dim_names=("data", "map"))
    group = mesh.get_group("map")
    if dist.get_backend(group) == "nccl" and map > 1:
        from . import peer

        _peers[group.group_name] = peer.attach(
            group, torch.device("cuda", torch.cuda.current_device()))
    return mesh
