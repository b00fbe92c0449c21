"""Kinematically-constrained ICP (2-DoF Gauss-Newton on the unicycle model).

Equivalent of ``kinematic_icp::KinematicRegistration``
(Registration.cpp:151-190) in its candidate-cached form: candidate map
points are gathered once per frame at the initial guess
``last_pose * relative_wheel_odometry``, and the Gauss-Newton iterations
re-select among them (``gn.gn_solve``).  With no correspondences the
update is forced to zero and the guess comes back, matching the
reference's early return for an empty map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import gn, hashmap, se3
from .points import transform


class RegistrationDebug(NamedTuple):
    iterations: torch.Tensor           # int32 — GN iterations executed
    num_correspondences: torch.Tensor  # int32 — at the final pose
    #: scalar f32 — the adaptive threshold's point-space error
    #: |t_err| + 2 R sin(theta_err/2) of guess^-1 @ pose, from the solve
    odometry_error_pt: torch.Tensor | None = None


def compute_robot_motion(m: hashmap.MapState, source, source_mask,
                         last_pose, relative_wheel_odometry,
                         max_correspondence_distance,
                         *, voxel_size: float, max_probes: int,
                         max_num_iterations: int, convergence_criterion: float,
                         use_adaptive_odometry_regularization: bool,
                         fixed_regularization: float,
                         num_candidate_voxels: int = 27,
                         exact_gn_reassociation: bool = False,
                         exact_prune_candidates: int = 0,
                         gn_candidates_per_voxel: int = 0,
                         gn_backend: str = "auto",
                         threshold_max_range: float = 0.0):
    """ComputeRobotMotion, candidate-cached branch.

    ``gn_backend``: "cuda"/"auto" launch the GN kernel on CUDA tensors,
    "torch" runs its plain version; CPU tensors take the plain version.
    Returns (new_pose (4, 4), RegistrationDebug).
    """
    for name, value in (("exact_gn_reassociation", exact_gn_reassociation),
                        ("exact_prune_candidates", exact_prune_candidates),
                        ("gn_candidates_per_voxel", gn_candidates_per_voxel)):
        if value:
            raise NotImplementedError(
                f"{name}: only the candidate-cached registration branch is "
                "ported; the others are ROADMAP.md queue A, item 8")
    guess = se3.compose44(last_pose, relative_wheel_odometry)
    world_guess = transform(guess, source)
    cand = hashmap.gather_candidates(m, world_guess, voxel_size, max_probes,
                                     num_candidate_voxels)
    pose, iters, num_corr, err, _ = gn.gn_solve(
        cand, source, source_mask, guess, max_correspondence_distance,
        voxel_size=voxel_size, max_num_iterations=max_num_iterations,
        convergence_criterion=convergence_criterion,
        use_adaptive_regularization=use_adaptive_odometry_regularization,
        fixed_regularization=fixed_regularization,
        max_range=threshold_max_range, backend=gn_backend)
    return pose, RegistrationDebug(iterations=iters,
                                   num_correspondences=num_corr,
                                   odometry_error_pt=err)
