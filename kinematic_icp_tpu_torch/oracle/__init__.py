"""CPU float64 oracle of the reference algorithm (for tests and baselines)."""

from .reference import OracleKinematicICP

__all__ = ["OracleKinematicICP"]
