"""Where the port's entry points run: the card unless the caller says not.

Every public constructor that takes ``device=None`` (``Simulator``,
``engine.init_state``, ``observables.init_recorder``) resolves it here, so a
state, a recorder and the simulator that uses them land on one device.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` for ``None``, raising when no card is visible (never a silent
    fall back to the CPU); otherwise the device the caller named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on an NVIDIA GPU by default and none is "
                "visible; pass device='cpu' to run the plain torch versions "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)
