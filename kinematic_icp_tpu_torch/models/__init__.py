"""Pipeline models: the per-frame odometry step and its state."""

from .pipeline import (FrameOutputs, OdometryState, init_state,
                       register_frame, set_pose)

__all__ = [
    "FrameOutputs", "OdometryState", "init_state", "register_frame",
    "set_pose",
]
