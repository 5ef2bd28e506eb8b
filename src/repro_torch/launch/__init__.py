"""repro_torch.launch: command-line drivers (``serve``: the multi-tenant
simulation service)."""
