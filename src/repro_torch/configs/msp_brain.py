"""The MSP structural-plasticity brain configuration (the port's own copy).

The fields, defaults and the two named configurations are those of the JAX
package's ``repro.configs.msp_brain``; the port keeps its own copy so that it
imports nothing of that package. Numbers follow the paper's quality
experiment (§V-D): target calcium 0.7, element growth rate 1e-3, background
activity N(5,1), Delta=100, connectivity update every 100 steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class BrainConfig:
    name: str = "msp-brain"
    neurons_per_rank: int = 1024
    # --- neuron / plasticity model (paper §III-A, §V-D) ---
    fraction_excitatory: float = 0.8
    target_calcium: float = 0.7        # epsilon (paper §V-D)
    calcium_decay: float = 1e-4        # c += -c*decay + beta*spiked
    calcium_beta: float = 2.4e-3
    element_growth_rate: float = 1e-3  # nu (paper §V-D)
    background_mean: float = 5.0       # N(5,1) background input (paper §V-D)
    background_std: float = 1.0
    initial_vacant_low: float = 1.1    # paper: 1.1..1.5 vacant elements at t=0
    initial_vacant_high: float = 1.5
    synapse_weight: float = 15.0       # EPSP per spike (inhibitory: negative)
    # Izhikevich RS parameters
    izh_a: float = 0.02
    izh_b: float = 0.2
    izh_c: float = -65.0
    izh_d: float = 8.0
    # --- structural update cadence ---
    plasticity_period: int = 100       # connectivity update every 100 steps
    rate_period: int = 100             # Delta: firing-rate exchange period
    # --- Barnes-Hut ---
    theta: float = 0.3                 # acceptance criterion
    sigma: float = 0.25                # Gaussian kernel width (domain units)
    local_levels: int = 4              # octree levels below the branch level
    frontier_cap: int = 64             # static BH frontier size
    max_synapses: int = 32             # S_max per neuron (out and in)
    requests_cap_factor: int = 2       # request buffer head-room
    subs_cap_factor: int = 2           # sparse-exchange subscription head-room
    subs_cap_base: Optional[int] = None
    # --- algorithm selection (old = paper baseline, new = contribution) ---
    connectivity_alg: str = "new"      # 'old' (move data) | 'new' (move compute)
    spike_alg: str = "new"             # 'old' (per-step IDs) | 'new' (rates)
    rate_exchange: str = "dense"       # 'dense' (R, n) table | 'sparse'
    # lowerings: 'reference' = plain torch; 'fused' = the hand-written CUDA
    # kernel of that phase (kernels/) on a CUDA tensor
    activity_impl: str = "reference"
    connectivity_impl: str = "reference"
    tree_impl: str = "reference"
    apply_impl: str = "reference"
    # length of the per-chunk metrics ring (telemetry.metrics)
    metrics_history: int = 64
    seed: int = 0

    def __post_init__(self):
        # eager validation: unknown variant names and illegal combinations
        # fail at construction, with the allowed set listed
        from repro_torch.sim import registry
        registry.check_config(self)


SMOKE_CONFIG = BrainConfig(neurons_per_rank=64, local_levels=3, frontier_cap=32,
                           max_synapses=8)
CONFIG = BrainConfig(neurons_per_rank=65_536)
