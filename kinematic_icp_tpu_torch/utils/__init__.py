"""Host-side numpy utilities: synthetic data and trajectory metrics."""
