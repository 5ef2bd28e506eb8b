"""repro_torch.checkpoint: atomic, verified checkpoints in the JAX package's
on-disk layout (``manager``)."""
