"""Pipeline models: the per-frame odometry step and its state."""

from .pipeline import (FrameOutputs, OdometryState, Step, init_state,
                       make_step, register_frame, set_pose)

__all__ = [
    "FrameOutputs", "OdometryState", "Step", "init_state", "make_step",
    "register_frame", "set_pose",
]
