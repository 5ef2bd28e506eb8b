"""Per-neuron parameter tables: what ``table_for(cfg, None, n)`` gives.

The slice runs without a scenario, so this is the default two-population
table of the JAX package's ``scenarios/populations.py`` (RS excitatory and
inhibitory, split at ``cfg.fraction_excitatory``), built by the same
``build_table``/``population_sizes`` rules so that mixed populations can be
handed in as ``PopulationSpec`` tuples. Scenario files (regions, protocols)
arrive with ROADMAP.md Queue 1 item 4.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

IZHIKEVICH_PRESETS = {
    "RS": dict(izh_a=0.02, izh_b=0.2, izh_c=-65.0, izh_d=8.0),   # regular
    "IB": dict(izh_a=0.02, izh_b=0.2, izh_c=-55.0, izh_d=4.0),   # bursting
    "CH": dict(izh_a=0.02, izh_b=0.2, izh_c=-50.0, izh_d=2.0),   # chattering
    "FS": dict(izh_a=0.1, izh_b=0.2, izh_c=-65.0, izh_d=2.0),    # fast spike
    "LTS": dict(izh_a=0.02, izh_b=0.25, izh_c=-65.0, izh_d=2.0),  # low-thresh
}


@dataclass(frozen=True)
class PopulationSpec:
    """One homogeneous sub-population. ``None`` fields inherit BrainConfig."""
    name: str
    fraction: float
    izh_a: float = 0.02
    izh_b: float = 0.2
    izh_c: float = -65.0
    izh_d: float = 8.0
    is_excitatory: bool = True
    target_calcium: Optional[float] = None
    element_growth_rate: Optional[float] = None
    synapse_weight: Optional[float] = None   # magnitude; sign from excitatory


def population(name: str, fraction: float, kind: str = "RS",
               **overrides) -> PopulationSpec:
    spec = PopulationSpec(name=name, fraction=fraction,
                          **IZHIKEVICH_PRESETS[kind])
    return replace(spec, **overrides) if overrides else spec


def default_populations(cfg) -> Tuple[PopulationSpec, ...]:
    izh = dict(izh_a=cfg.izh_a, izh_b=cfg.izh_b, izh_c=cfg.izh_c,
               izh_d=cfg.izh_d)
    pops = [PopulationSpec(name="exc", fraction=cfg.fraction_excitatory,
                           is_excitatory=True, **izh)]
    if cfg.fraction_excitatory < 1.0:
        pops.append(PopulationSpec(name="inh",
                                   fraction=1.0 - cfg.fraction_excitatory,
                                   is_excitatory=False, **izh))
    return tuple(pops)


class PopulationTable(NamedTuple):
    """Per-neuron parameter tensors, all shape (n,); index with ``gid % n``."""
    pop_id: torch.Tensor             # int32
    izh_a: torch.Tensor              # float32
    izh_b: torch.Tensor
    izh_c: torch.Tensor
    izh_d: torch.Tensor
    target_calcium: torch.Tensor
    growth_rate: torch.Tensor
    synapse_weight: torch.Tensor     # SIGNED: +magnitude exc / -magnitude inh
    is_excitatory: torch.Tensor      # bool


def population_sizes(n: int, pops: Sequence[PopulationSpec]) -> np.ndarray:
    fr = np.asarray([p.fraction for p in pops], np.float64)
    if not np.isclose(fr.sum(), 1.0, atol=1e-6):
        raise ValueError(f"population fractions must sum to 1, got {fr.sum()}")
    bounds = np.floor(np.cumsum(fr) * n).astype(np.int64)
    bounds[-1] = n
    return np.diff(np.concatenate([[0], bounds]))


def build_table(cfg, pops: Sequence[PopulationSpec], n: int,
                device=None) -> PopulationTable:
    sizes = population_sizes(n, pops)

    def col(field, default, signed=False):
        vals = []
        for p, sz in zip(pops, sizes):
            v = getattr(p, field)
            v = default if v is None else v
            if signed:
                v = v if p.is_excitatory else -v
            vals.append(np.full(int(sz), v, np.float32))
        return torch.from_numpy(np.concatenate(vals)).to(device)

    pop_id = np.repeat(np.arange(len(pops), dtype=np.int32), sizes)
    exc = np.repeat(np.asarray([p.is_excitatory for p in pops]), sizes)
    return PopulationTable(
        pop_id=torch.from_numpy(pop_id).to(device),
        izh_a=col("izh_a", cfg.izh_a),
        izh_b=col("izh_b", cfg.izh_b),
        izh_c=col("izh_c", cfg.izh_c),
        izh_d=col("izh_d", cfg.izh_d),
        target_calcium=col("target_calcium", cfg.target_calcium),
        growth_rate=col("element_growth_rate", cfg.element_growth_rate),
        synapse_weight=col("synapse_weight", cfg.synapse_weight, signed=True),
        is_excitatory=torch.from_numpy(exc).to(device))


def table_for(cfg, scenario, n: int, device=None) -> PopulationTable:
    """The table a scenario implies; the slice supports ``scenario=None``
    only (the BrainConfig-equivalent default table)."""
    if scenario is not None:
        raise NotImplementedError(
            "scenarios are not ported yet; see ROADMAP.md Queue 1 item 4")
    return build_table(cfg, default_populations(cfg), n, device=device)
