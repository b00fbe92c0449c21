"""kinematic_icp_tpu_torch — Kinematic-ICP LiDAR odometry in PyTorch/CUDA.

The PyTorch port of ``kinematic_icp_tpu``: kinematically constrained
(unicycle model) point-to-point ICP against a device-resident voxel hash
map, with the per-frame Gauss-Newton solve as a hand-written CUDA kernel
(``csrc/gn_solve.cu``) for NVIDIA Hopper.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""

from .config import Config, ServerConfig

__version__ = "0.1.0"

__all__ = ["Config", "ServerConfig", "__version__"]
