"""Many sequences at once: batched lock-step on one card, and map-sharded
steps over a (data, map) mesh of ``torch.distributed`` ranks."""

from .batched import BatchedOdometryRunner
from .mesh import (initialize_distributed, make_mesh, map_route,
                   shutdown_distributed)
from .sharded import (init_sharded_state, make_sharded_step,
                      sharded_register_frame)

__all__ = [
    "BatchedOdometryRunner", "init_sharded_state", "initialize_distributed",
    "make_mesh", "make_sharded_step", "map_route", "sharded_register_frame",
    "shutdown_distributed",
]
