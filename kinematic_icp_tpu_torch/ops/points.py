"""Planar (structure-of-arrays) point sets: three flat x/y/z planes.

The (N, 3) form exists only at the host boundary, as in the JAX package.
A batch of B sequences holds (B, N) planes beside (B, ...) per-sequence
values (poses (B, 4, 4), scalars (B,)); unbatched, the axis is absent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class P3(NamedTuple):
    """A planar point set: three same-shape tensors (usually 1D)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def take(self, index):
        """The points at ``index`` along the last axis, row by row."""
        return P3(self.x.gather(-1, index), self.y.gather(-1, index),
                  self.z.gather(-1, index))

    @staticmethod
    def from_array(points):
        """(..., 3) -> P3 of (...,) planes."""
        return P3(points[..., 0], points[..., 1], points[..., 2])

    def astype(self, dtype):
        return P3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))


def per_row(x, planes: int = 1):
    """A per-sequence value (a 0-d scalar, or (B,) in a batch) against
    values with ``planes`` more trailing axes: a batch gains that many unit
    axes, a scalar stays a scalar (and keeps the type promotion of one)."""
    return x.reshape(x.shape + (1,) * planes) if x.dim() else x


def transform(pose, p: P3) -> P3:
    """Apply a (4, 4) rigid transform to planar points, or a (B, 4, 4)
    batch of them to (B, N) planes."""
    def e(i, j):
        return per_row(pose[..., i, j])

    return P3(
        e(0, 0) * p.x + e(0, 1) * p.y + e(0, 2) * p.z + e(0, 3),
        e(1, 0) * p.x + e(1, 1) * p.y + e(1, 2) * p.z + e(1, 3),
        e(2, 0) * p.x + e(2, 1) * p.y + e(2, 2) * p.z + e(2, 3),
    )


def norm2(p: P3):
    return p.x * p.x + p.y * p.y + p.z * p.z


def norm(p: P3):
    return torch.sqrt(norm2(p))


def sub(a: P3, b: P3) -> P3:
    return P3(a.x - b.x, a.y - b.y, a.z - b.z)


def dot(a: P3, b: P3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def where(cond, a: P3, b: P3) -> P3:
    """Pointwise select; a ``cond`` with fewer axes than the planes is per
    sequence (a 0-d scalar, or (B,) against (B, N) planes)."""
    if cond.dim() < a.x.dim():
        cond = per_row(cond, a.x.dim() - cond.dim())
    return P3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


def zeros_like(p: P3) -> P3:
    return P3(torch.zeros_like(p.x), torch.zeros_like(p.y),
              torch.zeros_like(p.z))


def row_sum(x):
    """Sum over the last axis in an order fixed by that axis's length
    alone: zero-padded to a power of two, then halved by elementwise adds
    (``x[..., :h] + x[..., h:]``).  Each row's sum is the same bits
    whatever the leading axes hold and on any device.  ``torch.sum``'s CUDA
    reduction adds a row in an order that depends on the number of rows
    (on an H100, 1 of 4 rows of a (4, 1024) sum matched the row summed
    alone: ``tools/loop_batch_invariance.py``), which moved the loop
    lowering's results between a batch and B = 1."""
    width = 1 << max(x.shape[-1] - 1, 0).bit_length()
    if width != x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]
