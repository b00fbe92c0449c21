"""Float64 numpy helpers shared with the reference oracle."""
