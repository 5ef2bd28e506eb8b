"""MSP phase 1+2 state: the per-neuron tensors, their initial draw, the
per-step update rules, and the rate refresh that closes a rate window
(paper §III-A; parameters §V-D).

The engine's activity phase runs ``kernels/activity_fused.py::step_core``
(the plain version of the activity window, K1), which absorbed the math of
``update_activity`` and ``update_elements``. Those two remain the standalone
form of the model, as in the JAX package: applied in turn they are the plain
version of K8 (``kernels/neuron_step.py::neuron_step_plain``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.device import resolve_device


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
                 is_excitatory=None, device=None) -> NeuronState:
    """The reference's initial neuron state. ``key``: a key tensor (its
    device decides) or two u32 words (on ``device``, the card by default);
    its split is taken on the host, and on the card the vacant elements are
    one launch of K0's draw kernel."""
    p = params or params_from_config(cfg)
    dev = key.device if isinstance(key, torch.Tensor) else \
        resolve_device(device)
    k1, _ = prng.split_words(prng.as_words(key))
    vac = prng.uniform(k1, (n, 2), minval=cfg.initial_vacant_low,
                       maxval=cfg.initial_vacant_high, device=dev)
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


def _f32(x, device):
    """A parameter as a float32 tensor on ``device``: torch divides a CUDA
    tensor by a Python scalar as a multiply by its reciprocal, which differs
    in the last bit from the true division of the reference and the
    kernels."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def izhikevich_step(st: NeuronState, syn_input, noise, cfg,
                    params: Optional[NeuronParams] = None):
    """One 1 ms step (two 0.5 ms Euler halves). ``noise`` None: the input
    current is ``syn_input`` itself. Returns (v, u, spiked)."""
    p = params or params_from_config(cfg)
    dev = st.v.device
    a, b, c, d = (_f32(x, dev) for x in (p.izh_a, p.izh_b, p.izh_c, p.izh_d))
    i_t = syn_input if noise is None else syn_input + noise
    v, u = st.v, st.u
    for _ in range(2):
        v = v + 0.5 * (0.04 * v * v + 5.0 * v + 140.0 - u + i_t)
    u = u + a * (b * v - u)
    spiked = v >= 30.0
    v = torch.where(spiked, c, v)
    u = torch.where(spiked, u + d, u)
    return v, u, spiked


def update_activity(st: NeuronState, syn_input, noise, cfg,
                    params: Optional[NeuronParams] = None,
                    alive=None) -> NeuronState:
    """Izhikevich step, calcium and spike count. Dead neurons (``alive``
    False) do not fire, rest at c and keep their u."""
    p = params or params_from_config(cfg)
    v, u, spiked = izhikevich_step(st, syn_input, noise, cfg, p)
    if alive is not None:
        spiked = spiked & alive
        v = torch.where(alive, v, torch.broadcast_to(
            _f32(p.izh_c, v.device), v.shape))
        u = torch.where(alive, u, st.u)
    calcium = st.calcium + (-st.calcium * cfg.calcium_decay
                            + cfg.calcium_beta * spiked)
    return st._replace(v=v, u=u, spiked=spiked, calcium=calcium,
                       spike_count=st.spike_count + spiked)


def update_elements(st: NeuronState, cfg,
                    params: Optional[NeuronParams] = None,
                    alive=None) -> NeuronState:
    """Homeostasis: elements grow below the target calcium and retract above
    it (nu = growth rate); dead neurons lose all their elements."""
    p = params or params_from_config(cfg)
    dev = st.v.device
    drive = 1.0 - st.calcium / _f32(p.target_calcium, dev)
    grow = _f32(p.growth_rate, dev) * drive
    ax = torch.clamp_min(st.ax_elements + grow, 0.0)
    de = torch.clamp_min(st.de_elements + grow, 0.0)
    if alive is not None:
        ax = torch.where(alive, ax, 0.0)
        de = torch.where(alive, de, 0.0)
    return st._replace(ax_elements=ax, de_elements=de)


def refresh_rate(st: NeuronState, cfg, alive=None) -> NeuronState:
    """Close a rate window: advertised rate = spikes / Delta. Dead neurons
    (``alive`` False) advertise zero."""
    rate = st.spike_count / float(cfg.rate_period)
    if alive is not None:
        rate = torch.where(alive, rate, 0.0)
    return st._replace(rate=rate, spike_count=torch.zeros_like(st.spike_count))
