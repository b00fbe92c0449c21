"""Where the full-27 search takes the CUDA kernel (``ops/nn27.py``).

The kernel itself runs only on a card (``tests/test_torch_kernels.py``
holds it to the plain version there); these tests hold the decision,
which depends only on what the call can observe, and the routing of
``hashmap.nearest_neighbor`` on it."""

import types

import numpy as np
import pytest
import torch

from kinematic_icp_tpu_torch.ops import hashmap, nn27
from kinematic_icp_tpu_torch.ops.points import P3

torch.set_num_threads(1)


def _stub(is_cuda, dtype=torch.int32):
    """A stand-in for a tensor on a card, as far as ``applies`` looks."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)


@pytest.mark.parametrize("table_cuda,q_cuda,dtype,v,want", [
    (True, True, torch.float32, 27, True),
    (False, False, torch.float32, 27, False),   # CPU tensors
    (True, False, torch.float32, 27, False),
    (False, True, torch.float32, 27, False),
    (True, True, torch.float64, 27, True),      # a float64 state
    (True, True, torch.float32, 26, False),     # a pruned neighbourhood
    (True, True, torch.float32, 10, False),
])
def test_the_kernel_applies_to_cuda_full_neighbourhoods(
        table_cuda, q_cuda, dtype, v, want):
    x = _stub(q_cuda, dtype)
    assert nn27.applies(_stub(table_cuda), P3(x, x, x), v) is want


def _scene(dtype, n=256, batch=0):
    rng = np.random.default_rng(3)
    m = hashmap.empty(1 << 10, 20)
    pts = rng.uniform(-3.0, 3.0, (800, 3)).astype(np.float32)
    m = hashmap.insert(m, P3.from_array(torch.from_numpy(pts)),
                       torch.ones(len(pts), dtype=torch.bool), 1.0, 4)
    q = (pts[:n] + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    q = P3.from_array(torch.from_numpy(q).to(dtype))
    mask = torch.from_numpy(rng.uniform(size=n) < 0.7)
    if batch:
        m = hashmap.MapState(m.table.expand(batch, *m.table.shape).clone(),
                             m.bucket_slots)
        q = P3(*(c.expand(batch, n).clone() for c in q))
        mask = mask.expand(batch, n).clone()
    return m, q, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("v", [27, 14])
@pytest.mark.parametrize("batch", [0, 4])
def test_cpu_search_takes_the_plain_version(monkeypatch, dtype, v, batch):
    """On CPU tensors ``nearest_neighbor`` never reaches the kernel's
    wrapper and gives the plain gather and selection's bits."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(nn27, "nearest_neighbor", refuse)
    m, q, mask = _scene(dtype, batch=batch)
    got = hashmap.nearest_neighbor(m, q, mask, 1.0, 4, v)
    want = hashmap.nn_from_candidates(
        hashmap.gather_candidates(m, q, 1.0, 4, v), q, mask, 1.0)
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    assert torch.isinf(got[1][~mask]).all()
    assert torch.isfinite(got[1][mask]).any()


def test_search_goes_to_the_kernel_where_it_applies(monkeypatch):
    """Where ``applies`` holds, ``nearest_neighbor`` returns the kernel
    wrapper's result for the same map, queries, mask and voxel size, and
    gathers nothing itself."""
    m, q, mask = _scene(torch.float32)
    seen = []

    def wrapper(*args):
        seen.append(args)
        return "kernel"

    monkeypatch.setattr(nn27, "applies", lambda table, q, v: v == 27)
    monkeypatch.setattr(nn27, "nearest_neighbor", wrapper)
    monkeypatch.setattr(hashmap, "gather_candidates", None)
    assert hashmap.nearest_neighbor(m, q, mask, 0.5, 4) == "kernel"
    assert seen == [(m, q, mask, 0.5)]
