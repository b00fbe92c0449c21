"""The GN kernel's share of its roofline over the traced chunks (a launch solves the batch of 8 lanes), in %:
``core.roofline.gn_share`` (the bytes term alone: the benchmark cannot
read the passes a frame took)."""

from icp_bench.core.roofline import gn_share as read  # noqa: F401
