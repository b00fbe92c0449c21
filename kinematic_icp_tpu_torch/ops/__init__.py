"""Device ops: geometry, preprocessing, voxel map, registration, GN kernel."""

from . import (gn, hashmap, motion_model, preprocessing, registration, se3,
               threshold, voxel)

__all__ = [
    "gn", "hashmap", "motion_model", "preprocessing", "registration", "se3",
    "threshold", "voxel",
]
