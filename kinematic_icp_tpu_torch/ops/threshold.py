"""Adaptive correspondence threshold (reference CorrespondenceThreshold)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class ThresholdState(NamedTuple):
    odom_sse: torch.Tensor     # scalar, (B,) in a batch
    num_samples: torch.Tensor  # scalar, (B,) in a batch


def init_state(dtype=torch.float32, device=None) -> ThresholdState:
    """Reset state (reference CorrespondenceThreshold.hpp:40-43)."""
    return ThresholdState(
        odom_sse=torch.zeros((), dtype=dtype, device=device),
        num_samples=torch.full((), 1e-8, dtype=dtype, device=device),
    )


def compute_threshold(state: ThresholdState, *, map_discretization_error: float,
                      use_adaptive: bool, fixed_threshold: float):
    """tau = 3 * (sigma_map + sigma_odom)  (CorrespondenceThreshold.cpp:27-35)."""
    if not use_adaptive:
        return torch.full_like(state.odom_sse, fixed_threshold)
    sigma_odom = torch.sqrt(state.odom_sse / state.num_samples)
    return 3.0 * (map_discretization_error + sigma_odom)


def odometry_error_in_point_space(pose, max_range: float):
    """|t| + 2 * max_range * sin(theta/2)  (CorrespondenceThreshold.cpp:7-12)."""
    theta = se3.rotation_angle(pose)
    delta_rot = 2.0 * max_range * torch.sin(theta / 2.0)
    delta_trans = torch.linalg.vector_norm(pose[..., :3, 3], dim=-1)
    return delta_trans + delta_rot


def update_odometry_error(state: ThresholdState, odometry_error_pose, *,
                          max_range: float, use_adaptive: bool) -> ThresholdState:
    """Accumulate squared odometry error (CorrespondenceThreshold.cpp:37-44)."""
    if not use_adaptive:
        return state
    err = odometry_error_in_point_space(odometry_error_pose, max_range)
    return update_odometry_error_scalar(state, err, use_adaptive=True)


def update_odometry_error_scalar(state: ThresholdState, err, *,
                                 use_adaptive: bool) -> ThresholdState:
    """Accumulate a precomputed point-space error (CorrespondenceThreshold
    .cpp:37-44); the kernel branches of the GN solve return it with the
    pose."""
    if not use_adaptive:
        return state
    return ThresholdState(
        odom_sse=state.odom_sse + err * err,
        num_samples=state.num_samples + 1.0,
    )
