"""The full-27 nearest-neighbour search: one launch of a CUDA kernel.

``nearest_neighbor`` is ``hashmap.nearest_neighbor`` at V = 27 (the
reference's GetClosestNeighbor over the 27 voxels around each query,
Registration.cpp:69-79) in one launch of the hand-written kernel
``csrc/nn27.cu``, which reads the bucket rows where they lie and writes
only the outputs.  The plain version is ``hashmap``'s own (one
``gather_candidates`` at V = 27, then ``nn_from_candidates``), and the
kernel gives its bits on every live query: the nearest point and its
distance.  A query whose mask is clear reads no bucket; its distance is
inf, as the plain version's, and its nearest point is the query itself.

``hashmap.nearest_neighbor`` takes the kernel wherever ``applies`` says,
which depends only on what the call can observe: the table and the
queries on a CUDA device, and the whole neighbourhood.  The kernel has a
float32 and a float64 instance, so a float64 state takes it too (any
other query type raises).  Its callers are the exact modes' full-27 loop
(the certified solve's fallback and the plain loop) and the sharded exact
path's per-shard search.  CPU tensors and a pruned neighbourhood keep the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .points import P3

#: kernel launches so far (a plain count, bumped where ``nearest_neighbor``
#: launches or a capture records a launch; a replay adds nothing, and a
#: launch inside a conditional body is counted where it is captured)
LAUNCHES = 0


def applies(table, q: P3, num_candidate_voxels: int) -> bool:
    """Whether ``hashmap.nearest_neighbor`` launches the kernel."""
    return num_candidate_voxels == 27 and table.is_cuda and q.x.is_cuda


def _kernel_entry():
    """``kicp_nn27`` of the built library, with its C signature."""
    fn = cuda_build.load("nn27").kicp_nn27
    if fn.argtypes is None:
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [p, p, i, i, i, i, i, p, p, p, p, i, d, d, d, p]
        fn.restype = i
    return fn


def nearest_neighbor(m, q: P3, query_mask, voxel_size: float):
    """The nearest stored point of each query among the 27 voxels around
    it, and its distance: (P3 of (N,) planes, dist (N,)), inf where the
    query's mask is clear or no point is stored there.  A batched map
    ((B, NB, G*R) table) takes (B, N) queries and gives (B, N) of each."""
    global LAUNCHES
    table = m.table
    batched = table.dim() == 3
    rows = table if batched else table[None]
    b, nb, g, k = rows.shape[0], m.num_buckets, m.bucket_slots, m.block_size
    if k > 32:
        raise ValueError("packed argmin key holds a 5-bit entry lane")
    shape = tuple(q.x.shape)
    if shape != ((b, shape[-1]) if batched else (shape[-1],)):
        raise ValueError(f"nn27 kernel: queries {shape} for a table of "
                         f"{tuple(table.shape)}")
    dev, dtype = table.device, q.x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"nn27 kernel: float32 or float64 queries; got "
                         f"{dtype}")
    planes = [t.contiguous() for t in q]
    for name, t in zip("xyz", planes):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"nn27 kernel: q.{name} must be {dtype} "
                             f"{shape} on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    mask = query_mask.contiguous()
    if mask.device != dev or mask.dtype != torch.bool \
            or tuple(mask.shape) != shape:
        raise ValueError(f"nn27 kernel: query_mask must be bool {shape} on "
                         f"{dev}; got {mask.dtype} {tuple(mask.shape)}")
    rows = rows.contiguous()
    out = torch.empty((4, *shape), dtype=dtype, device=dev)
    if out.numel():
        fn = _kernel_entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(stream, rows.data_ptr(), b, nb, g, k,
                    int(dtype == torch.float64),
                    *(t.data_ptr() for t in planes), mask.data_ptr(),
                    shape[-1], 1.0 / voxel_size, voxel_size,
                    voxel_size / 1024,  # 10-bit offsets (hashmap._QUANT)
                    out.data_ptr())
        if rc != 0:
            raise RuntimeError(f"nn27 kernel launch over {shape} queries "
                               f"failed: CUDA error {rc}")
        LAUNCHES += 1
    return P3(out[0], out[1], out[2]), out[3]
