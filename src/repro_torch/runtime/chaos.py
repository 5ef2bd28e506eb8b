"""Chaos hooks: faults injected on purpose to test recovery. The port's copy
of ``drop_region_input`` from the JAX package's ``repro/runtime/chaos.py``;
the service's and the runner's hooks come with the runtime."""
from __future__ import annotations


def drop_region_input(region, chunks: int = 2, after_chunk: int = 0):
    """Assimilation-loop hook: once the loop reaches ``after_chunk``, zero
    ``region``'s external background drive for ``chunks`` chunks, exactly
    once (``workloads.assimilate.AssimilationLoop.drop``). The controller
    must see the rate collapse and wind the drive back up after the drop
    window closes."""
    fired = {"done": False}

    def hook(loop):
        if fired["done"] or loop.chunk_index < after_chunk:
            return
        fired["done"] = True
        loop.drop(region, chunks)

    return hook
