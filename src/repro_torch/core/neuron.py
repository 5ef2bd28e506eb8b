"""MSP phase 1+2 state: the per-neuron tensors, their initial draw, and the
rate refresh that closes a rate window (paper §III-A; parameters §V-D).

The per-step update rule itself is ``kernels/activity_fused.py::step_core``
(the plain version of the activity window, K1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng


class NeuronParams(NamedTuple):
    """Izhikevich + plasticity constants, scalar or per-neuron (n,)."""
    izh_a: object
    izh_b: object
    izh_c: object
    izh_d: object
    growth_rate: object      # nu
    target_calcium: object   # epsilon


def params_from_config(cfg) -> NeuronParams:
    return NeuronParams(cfg.izh_a, cfg.izh_b, cfg.izh_c, cfg.izh_d,
                        cfg.element_growth_rate, cfg.target_calcium)


class NeuronState(NamedTuple):
    v: torch.Tensor            # (n,) membrane potential
    u: torch.Tensor            # (n,) recovery variable
    calcium: torch.Tensor      # (n,) intracellular calcium
    ax_elements: torch.Tensor  # (n,) axonal synaptic elements
    de_elements: torch.Tensor  # (n,) dendritic synaptic elements
    spiked: torch.Tensor       # (n,) bool — fired in the last step
    spike_count: torch.Tensor  # (n,) spikes in the current rate window
    rate: torch.Tensor         # (n,) advertised firing rate
    is_excitatory: torch.Tensor  # (n,) bool


def init_neurons(key, cfg, n: int, params: Optional[NeuronParams] = None,
                 is_excitatory=None) -> NeuronState:
    p = params or params_from_config(cfg)
    dev = key.device
    k1, _ = prng.split(key)
    vac = prng.uniform(k1, (n, 2), minval=cfg.initial_vacant_low,
                       maxval=cfg.initial_vacant_high)
    exc = torch.arange(n, device=dev) < int(n * cfg.fraction_excitatory) \
        if is_excitatory is None else is_excitatory

    def vec(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32,
                                                  device=dev), (n,)).clone()

    return NeuronState(
        v=vec(p.izh_c),
        u=vec(torch.as_tensor(p.izh_b, dtype=torch.float32, device=dev)
              * torch.as_tensor(p.izh_c, dtype=torch.float32, device=dev)),
        calcium=torch.zeros(n, dtype=torch.float32, device=dev),
        ax_elements=vac[:, 0].contiguous(), de_elements=vac[:, 1].contiguous(),
        spiked=torch.zeros(n, dtype=torch.bool, device=dev),
        spike_count=torch.zeros(n, dtype=torch.float32, device=dev),
        rate=torch.zeros(n, dtype=torch.float32, device=dev),
        is_excitatory=exc)


def refresh_rate(st: NeuronState, cfg, alive=None) -> NeuronState:
    """Close a rate window: advertised rate = spikes / Delta. Dead neurons
    (``alive`` False) advertise zero."""
    rate = st.spike_count / float(cfg.rate_period)
    if alive is not None:
        rate = torch.where(alive, rate, 0.0)
    return st._replace(rate=rate, spike_count=torch.zeros_like(st.spike_count))
