"""repro_torch.parallel: the LM stack on a mesh of named axes (the sharding
rules and the explicit partitioning, int8 gradient compression, pipeline
stages)."""
