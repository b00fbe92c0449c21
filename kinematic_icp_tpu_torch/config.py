"""Configuration of the PyTorch/CUDA Kinematic-ICP pipeline.

Same fields and defaults as the JAX package's ``Config`` (the reference
``kinematic_icp::pipeline::Config`` plus the static capacities that replace
its dynamically sized containers), so one set of values drives both
packages.  ``gn_backend`` names this package's Gauss-Newton lowerings:
``cuda`` takes the kernel branches of the registration (the hand-written
kernel ``csrc/gn_solve.cu``, or its plain version on CPU tensors),
``torch`` the loop branches (JAX's ``xla``), and ``auto`` is ``cuda`` for
CUDA tensors and ``torch`` for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math

#: JAX ``gn_backend`` names -> this package's
_BACKEND_FROM_JAX = {"pallas": "cuda", "xla": "torch", "auto": "auto"}


@dataclasses.dataclass(frozen=True)
class Config:
    """Algorithm parameters (defaults = reference KinematicICP.hpp:38-60)."""

    # Preprocessing
    max_range: float = 100.0
    min_range: float = 0.0
    # Mapping parameters
    voxel_size: float = 1.0
    max_points_per_voxel: int = 20
    # Correspondence threshold parameters
    use_adaptive_threshold: bool = True
    fixed_threshold: float = 1.0
    # Registration parameters
    max_num_iterations: int = 10
    convergence_criterion: float = 0.001
    use_adaptive_odometry_regularization: bool = True
    fixed_regularization: float = 0.0
    # Motion compensation
    deskew: bool = False

    #: padded per-scan point capacity
    max_points: int = 65536
    #: capacity of the 0.5*voxel_size downsampled cloud (map-update cloud)
    max_downsampled: int = 16384
    #: capacity of the 1.5*voxel_size downsampled cloud (ICP source points)
    max_source: int = 8192
    #: voxel slots in the hash table (max_probes x a power-of-two buckets)
    map_capacity: int = 1 << 18
    #: slots per bucket
    max_probes: int = 4
    #: candidate voxels fetched per nearest-neighbour query (27 = all)
    neighbor_candidates: int = 10
    #: re-gather the 27-voxel neighbourhood on every GN iteration (the
    #: reference's behaviour; "cuda" runs the kernel's certified solve with
    #: a full-27 fallback, "torch" the full-27 loop)
    exact_gn_reassociation: bool = False
    #: with exact_gn_reassociation and the "torch" loop: re-gather only the
    #: V nearest voxels, with a certificate and a full-27 fallback, so the
    #: result equals the full loop bit for bit; 0 disables pruning
    exact_prune_candidates: int = 0
    #: keep only the top-M candidates per voxel (ranked at the initial
    #: guess) for the candidate-cached solve; 0 keeps all
    gn_candidates_per_voxel: int = 0
    #: "cuda" | "torch" | "auto" (see the module docstring)
    gn_backend: str = "auto"
    #: wide-frame downsample representative: "first" or "min"
    downsample_tiebreak: str = "first"

    def __post_init__(self):
        b = self.map_capacity // self.max_probes
        if b * self.max_probes != self.map_capacity or b & (b - 1):
            raise ValueError(
                "map_capacity must be max_probes x a power-of-two bucket count")
        if self.gn_backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"gn_backend {self.gn_backend!r}")
        if self.downsample_tiebreak not in ("first", "min"):
            raise ValueError(f"downsample_tiebreak {self.downsample_tiebreak!r}")

    def map_resolution(self) -> float:
        """Derived parameter (reference KinematicICP.hpp:46)."""
        return self.voxel_size / math.sqrt(self.max_points_per_voxel)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Build from a mapping such as ``dataclasses.asdict`` of the JAX
        ``Config``; its backend names map ``pallas``->``cuda`` and
        ``xla``->``torch``."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "gn_backend" in kw:
            kw["gn_backend"] = _BACKEND_FROM_JAX.get(kw["gn_backend"],
                                                     kw["gn_backend"])
        return cls(**kw)

    def to_jax_dict(self) -> dict:
        """``dataclasses.asdict`` under the JAX package's backend names
        (``cuda``->``pallas``, ``torch``->``xla``), so the JAX ``Config``
        takes it as keyword arguments."""
        d = dataclasses.asdict(self)
        d["gn_backend"] = _BACKEND_TO_JAX[d["gn_backend"]]
        return d


_BACKEND_TO_JAX = {v: k for k, v in _BACKEND_FROM_JAX.items()}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Ingestion/serving-layer parameters.

    Mirrors the ROS-parameter surface of the reference
    ``LidarOdometryServer`` (LidarOdometryServer.cpp:40-46,127-130) minus the
    tf-frame plumbing that a pure-array pipeline does not need.
    """

    lidar_odom_frame: str = "odom_lidar"
    wheel_odom_frame: str = "odom"
    base_frame: str = "base_link"
    publish_odom_tf: bool = True
    invert_odom_tf: bool = True
    tf_timeout: float = 0.0
    position_covariance: float = 0.1
    orientation_covariance: float = 0.1
    #: skip registration when the wheel-odometry delta is below this
    #: (reference LidarOdometryServer.cpp:202)
    stationary_gate: float = 1e-3


def load_yaml_config(path: str) -> tuple[Config, ServerConfig]:
    """Load a reference-style ROS parameter YAML.

    Accepts the file the reference ships (ros/config/kinematic_icp_ros.yaml),
    including the ROS ``<node>: ros__parameters:`` nesting, as well as a
    flat mapping.  Needs PyYAML, imported here and nowhere else.
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    # Unwrap ROS nesting: {node_name: {ros__parameters: {...}}}
    params = raw
    if len(raw) == 1:
        inner = next(iter(raw.values()))
        if isinstance(inner, dict) and "ros__parameters" in inner:
            params = inner["ros__parameters"]
    if "ros__parameters" in params:
        params = params["ros__parameters"]

    srv_fields = {f.name for f in dataclasses.fields(ServerConfig)}
    cfg = Config.from_dict(params)
    # Reference guard: max_range < min_range => min_range = 0
    # (LidarOdometryServer.cpp:98-102)
    if cfg.max_range < cfg.min_range:
        cfg = cfg.replace(min_range=0.0)
    return cfg, ServerConfig(**{k: v for k, v in params.items()
                                if k in srv_fields})
