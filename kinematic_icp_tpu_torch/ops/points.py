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
