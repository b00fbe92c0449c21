"""Unicycle (2-DoF) kinematic motion model.

Maps integrated controls ``(rho, theta)`` to the SE(3) delta
``exp((rho sin(t)/t, rho (1 - cos t)/t, 0, 0, 0, t))`` (reference
Registration.cpp:159-167) with float32-stable sinc forms.
"""

from __future__ import annotations

import torch

from . import se3

_SMALL = 1e-6


def control_to_twist(controls):
    """(..., 2) (rho, theta) -> (..., 6) se(3) tangent (v, w)."""
    rho = controls[..., 0]
    theta = controls[..., 1]
    t2 = theta * theta
    small = torch.abs(theta) < _SMALL
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    sinc = torch.where(small, 1.0 - t2 / 6.0,
                       torch.sin(safe_theta) / safe_theta)
    # (1 - cos t)/t as 2 sin^2(t/2)/t: the naive form is 0 in float32
    # for |t| < ~3.4e-4.
    sh = torch.sin(0.5 * safe_theta)
    verc = torch.where(small, theta / 2.0 - t2 * theta / 24.0,
                       2.0 * sh * sh / safe_theta)
    zeros = torch.zeros_like(rho)
    return torch.stack([rho * sinc, rho * verc, zeros, zeros, zeros, theta],
                       dim=-1)


def motion_model(controls):
    """(..., 2) (rho, theta) -> (..., 4, 4) SE(3) delta transform."""
    return se3.se3_exp(control_to_twist(controls))
