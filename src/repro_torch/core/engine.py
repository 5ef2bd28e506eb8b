"""MSP simulation engine state and its initial draw.

One *chunk* = rate_period (Delta=100) activity steps + one connectivity
update. ``BrainState`` mirrors the JAX package's state field for field; the
slice holds the dense rate-exchange layout (the sparse fields stay None) and
keeps ``chunk`` as a host integer, since every kernel takes the chunk as a
runtime argument.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.core import morton
from repro_torch.core.neuron import NeuronParams, NeuronState, init_neurons
from repro_torch.device import resolve_device
from repro_torch.scenarios import populations as pops
from repro_torch.telemetry import metrics as telemetry_metrics


class BrainState(NamedTuple):
    neurons: NeuronState
    out_edges: torch.Tensor          # (n, S) int32 target gids, -1 empty
    in_edges: torch.Tensor           # (n, S) int32 source gids, -1 empty
    positions: torch.Tensor          # (n, 3) float32
    rates_table: Optional[torch.Tensor]    # (R, n) gathered rates (dense)
    subs: Optional[torch.Tensor]           # sparse layout: not ported
    rate_slots: Optional[torch.Tensor]
    remote_rates: Optional[torch.Tensor]
    chunk: int                       # chunks completed
    stats: telemetry_metrics.Metrics


def _neuron_params(table: pops.PopulationTable) -> NeuronParams:
    return NeuronParams(table.izh_a, table.izh_b, table.izh_c, table.izh_d,
                        table.growth_rate, table.target_calcium)


def init_state(cfg, rank: int, num_ranks: int, scenario=None,
               device=None) -> BrainState:
    """The reference's ``init_state``: positions and vacant elements from
    the same jax.random draws (``repro_torch.prng``), the scenario's
    population table, empty edge tables. On the card unless ``device``
    names another (``device.resolve_device``)."""
    if cfg.rate_exchange != "dense":
        raise NotImplementedError(
            "the sparse rate exchange is not ported yet (ROADMAP.md Queue 1 "
            "item 9)")
    device = resolve_device(device)
    n = cfg.neurons_per_rank
    key = prng.fold_in(prng.key(cfg.seed, device=device), rank)
    kp, kn = prng.split(key)
    b = morton.branch_level(num_ranks)
    c_per = morton.cells_per_rank(num_ranks)
    pos = morton.sample_positions_in_cells(kp, rank * c_per, c_per, n, b)
    table = pops.table_for(cfg, scenario, n, device=device)
    neurons = init_neurons(kn, cfg, n, params=_neuron_params(table),
                           is_excitatory=table.is_excitatory)
    edges = torch.full((n, cfg.max_synapses), -1, dtype=torch.int32,
                       device=device)
    stats = telemetry_metrics.init_metrics(cfg.metrics_history, device=device)
    rates_table = torch.zeros((num_ranks, n), dtype=torch.float32,
                              device=device)
    return BrainState(neurons, edges, edges.clone(), pos, rates_table, None,
                      None, None, 0, stats)
