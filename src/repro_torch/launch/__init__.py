"""repro_torch.launch: command-line drivers (``serve``: the multi-tenant
simulation service; ``serve_lm``: batched LM serving, prefill + KV-cache
decode)."""
