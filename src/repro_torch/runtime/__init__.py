"""repro_torch.runtime: the runtime around the simulator. So far only the
assimilation loop's chaos hook (``chaos.drop_region_input``)."""
