"""MSP simulation engine state and its initial draw.

One *chunk* = rate_period (Delta=100) activity steps + one connectivity
update. ``BrainState`` mirrors the JAX package's state field for field: the
dense rate exchange holds ``rates_table`` (the sparse fields None), the
sparse one ``subs``, ``rate_slots`` and ``remote_rates`` (``rates_table``
None). ``chunk`` is a host integer, since every kernel takes the chunk as a
runtime argument.

A state is one rank's. ``join_states`` makes the global view of R ranks'
states (the JAX package's global arrays: per-neuron rows concatenated in
rank order, so gid == global row; the replicated rates table once; the
metrics' leading axis the ranks), and ``split_state`` goes back;
``map_rank_rows`` maps the leaves that hold a rank's rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.connectome import routing
from repro_torch.core import morton, spikes
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
    subs: Optional[torch.Tensor]           # (subs_cap,) registry (sparse)
    rate_slots: Optional[torch.Tensor]     # (n, S) edge -> slot (sparse)
    remote_rates: Optional[torch.Tensor]   # (subs_cap,) pushed (sparse)
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
    device = resolve_device(device)
    n = cfg.neurons_per_rank
    # the keys as host words: the draws below are three launches of K0's
    # draw kernel on the card (randint (n,), uniform (n, 3) and (n, 2))
    key = prng.fold_in_words(prng.key_words(cfg.seed), rank)
    kp, kn = prng.split_words(key)
    b = morton.branch_level(num_ranks)
    c_per = morton.cells_per_rank(num_ranks)
    pos = morton.sample_positions_in_cells(kp, rank * c_per, c_per, n, b,
                                           device=device)
    table = pops.table_for(cfg, scenario, n, device=device)
    neurons = init_neurons(kn, cfg, n, params=_neuron_params(table),
                           is_excitatory=table.is_excitatory, device=device)
    edges = torch.full((n, cfg.max_synapses), -1, dtype=torch.int32,
                       device=device)
    stats = telemetry_metrics.init_metrics(cfg.metrics_history, device=device)
    rates_table = subs = rate_slots = remote_rates = None
    if cfg.rate_exchange == "dense":
        rates_table = torch.zeros((num_ranks, n), dtype=torch.float32,
                                  device=device)
    else:
        cap = routing.cap_subs(cfg, num_ranks)
        subs = torch.full((cap,), spikes.NO_SUB, dtype=torch.int32,
                          device=device)
        rate_slots = torch.full((n, cfg.max_synapses), -1, dtype=torch.int32,
                                device=device)
        remote_rates = torch.zeros(cap, dtype=torch.float32, device=device)
    return BrainState(neurons, edges, edges.clone(), pos, rates_table, subs,
                      rate_slots, remote_rates, 0, stats)


_ROW_FIELDS = ("out_edges", "in_edges", "positions", "subs", "rate_slots",
               "remote_rates")


def join_states(states) -> BrainState:
    """The global view of the ranks' states, in rank order (one state is
    its own view)."""
    if len(states) == 1:
        return states[0]
    chunks = {s.chunk for s in states}
    if len(chunks) != 1:
        raise ValueError(f"join_states: the ranks are at chunks {chunks}")
    neurons = NeuronState(*(torch.cat([getattr(s.neurons, f) for s in states])
                            for f in NeuronState._fields))
    rows = {f: None if getattr(states[0], f) is None
            else torch.cat([getattr(s, f) for s in states])
            for f in _ROW_FIELDS}
    return BrainState(neurons=neurons, rates_table=states[0].rates_table,
                      chunk=states[0].chunk,
                      stats=telemetry_metrics.join([s.stats for s in states]),
                      **rows)


def map_rank_rows(state: BrainState, fn) -> BrainState:
    """``state`` with ``fn`` applied to every leaf whose leading axis holds
    the rank's rows (the neurons, the row fields, the metrics' per-rank
    axis); the replicated rates table and the chunk as they are."""
    return state._replace(
        neurons=NeuronState(*(fn(x) for x in state.neurons)),
        stats=telemetry_metrics.map_leaves(state.stats, fn),
        **{f: None if getattr(state, f) is None else fn(getattr(state, f))
           for f in _ROW_FIELDS})


def split_state(state: BrainState, num_ranks: int) -> list:
    """A global state -> one state a rank (rank r holds rows r*n:(r+1)*n;
    each rank a copy of the replicated rates table)."""
    def part(x, r):
        if x is None:
            return None
        m = x.shape[0] // num_ranks
        return x[r * m:(r + 1) * m].clone()
    stats = telemetry_metrics.split(state.stats, num_ranks)
    return [BrainState(
        neurons=NeuronState(*(part(getattr(state.neurons, f), r)
                              for f in NeuronState._fields)),
        rates_table=None if state.rates_table is None
        else state.rates_table.clone(),
        chunk=state.chunk, stats=stats[r],
        **{f: part(getattr(state, f), r) for f in _ROW_FIELDS})
        for r in range(num_ranks)]
