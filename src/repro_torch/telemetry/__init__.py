"""Device-side metrics."""
