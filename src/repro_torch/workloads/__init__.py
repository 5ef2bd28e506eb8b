"""repro_torch.workloads: the workloads of the MSP brain, the port's copy of
the JAX package's ``repro.workloads``.

  datasets.py    the versioned on-disk connectome format (npz), the
                 deterministic hemibrain-shaped surrogate generator and the
                 edge-list -> (n, S) synapse-table builder behind
                 ``Simulator.from_connectome`` (numpy only)
  engram.py      train-with-stimulus / lesion-the-cue pattern completion,
                 reporting ``recall_overlap``
  assimilate.py  a host-driven rate-assimilation loop nudging per-region
                 drive toward a target trace between chunks, through
                 ``sim.phases.DynamicParams`` and ``Simulator.step_with``

Import is lazy (the modules pull in the full engine stack).
"""
from __future__ import annotations

_LAZY = {
    "ConnectomeDataset": ("repro_torch.workloads.datasets",
                          "ConnectomeDataset"),
    "generate_hemibrain_surrogate": (
        "repro_torch.workloads.datasets", "generate_hemibrain_surrogate"),
    "save": ("repro_torch.workloads.datasets", "save"),
    "load": ("repro_torch.workloads.datasets", "load"),
    "EngramSpec": ("repro_torch.workloads.engram", "EngramSpec"),
    "run_engram": ("repro_torch.workloads.engram", "run_engram"),
    "AssimilationLoop": ("repro_torch.workloads.assimilate",
                         "AssimilationLoop"),
}

__all__ = sorted(_LAZY) + ["assimilate", "datasets", "engram"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'repro_torch.workloads' has no attribute {name!r}")
