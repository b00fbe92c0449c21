"""Many sequences on one card: B drives advancing in lock-step."""

from .batched import BatchedOdometryRunner

__all__ = ["BatchedOdometryRunner"]
