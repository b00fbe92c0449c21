"""Planar (structure-of-arrays) point sets: three flat x/y/z planes.

The (N, 3) form exists only at the host boundary, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class P3(NamedTuple):
    """A planar point set: three same-shape tensors (usually 1D)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_array(points):
        """(..., 3) -> P3 of (...,) planes."""
        return P3(points[..., 0], points[..., 1], points[..., 2])

    def astype(self, dtype):
        return P3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))


def transform(pose, p: P3) -> P3:
    """Apply a (4, 4) rigid transform to planar points."""
    R = pose[:3, :3]
    t = pose[:3, 3]
    return P3(
        R[0, 0] * p.x + R[0, 1] * p.y + R[0, 2] * p.z + t[0],
        R[1, 0] * p.x + R[1, 1] * p.y + R[1, 2] * p.z + t[1],
        R[2, 0] * p.x + R[2, 1] * p.y + R[2, 2] * p.z + t[2],
    )
