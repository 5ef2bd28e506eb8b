"""PhaseContext + the engine-level phase implementations.

``PhaseContext`` bundles what every phase needs besides the state (config,
rank, rank count, the population table, the metrics recorder). The activity
lowerings register here; the connectivity, traversal, tree, apply and
rate-exchange lowerings register next to their implementations in
``repro_torch.connectome``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function

from repro_torch.connectome.update import connectivity_update
from repro_torch.kernels import activity_fused
from repro_torch.scenarios import populations as pops
from repro_torch.sim import registry
from repro_torch.telemetry import metrics as telemetry_metrics


@dataclass
class PhaseContext:
    """Everything a phase implementation needs besides the BrainState."""
    cfg: Any
    rank: int
    num_ranks: int
    table: Any = None
    metrics: Any = None


def make_context(cfg, rank: int, num_ranks: int, device=None) -> PhaseContext:
    table = pops.table_for(cfg, None, cfg.neurons_per_rank, device=device)
    return PhaseContext(cfg=cfg, rank=rank, num_ranks=num_ranks, table=table,
                        metrics=telemetry_metrics.Recorder(
                            n=cfg.neurons_per_rank))


# ================================================================ activity
def _window_args(ctx: PhaseContext):
    cfg, table = ctx.cfg, ctx.table
    izh = (table.izh_a, table.izh_b, table.izh_c, table.izh_d,
           table.growth_rate, table.target_calcium)
    return dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
                ca_consts=(cfg.calcium_decay, cfg.calcium_beta))


def _st7(neurons):
    return (neurons.v, neurons.u, neurons.calcium, neurons.ax_elements,
            neurons.de_elements, neurons.spiked, neurons.spike_count)


def _unpack_st7(neurons, out):
    return neurons._replace(v=out[0], u=out[1], calcium=out[2],
                            ax_elements=out[3], de_elements=out[4],
                            spiked=out[5], spike_count=out[6])


@registry.register_phase("spikes", "new")
def spikes_new(st7, state, ctx: PhaseContext, stats):
    """NEW spike transmission: no per-step exchange — step_core rebuilds
    remote spikes from the counter hash and the exchanged rates."""
    return None, stats


def _activity(state, ctx: PhaseContext, window):
    cfg = ctx.cfg
    out, spikes_per_step = window(
        _st7(state.neurons), state.in_edges, ctx.table.synapse_weight,
        state.rates_table, cfg.background_mean, cfg.background_std,
        state.chunk, ctx.rank, **_window_args(ctx))
    stats = ctx.metrics.activity_window(state.stats, spikes_per_step)
    return state._replace(neurons=_unpack_st7(state.neurons, out),
                          stats=stats)


@registry.register_phase("activity", "reference")
def activity_reference(state, ctx: PhaseContext):
    """Delta iterations of the plain torch ``step_core``."""
    return _activity(state, ctx, activity_fused.window_plain)


@registry.register_phase("activity", "fused")
def activity_fused_phase(state, ctx: PhaseContext):
    """The activity window kernel K1 (Delta launches per window)."""
    return _activity(state, ctx, activity_fused.activity_window)


def activity_phase(state, ctx: PhaseContext):
    return registry.resolve("activity", ctx.cfg.activity_impl)(state, ctx)


def connectivity_phase(state, ctx: PhaseContext):
    return connectivity_update(state, ctx)


# ================================================================ health
def health_verdict(state, ctx: PhaseContext):
    """The health gauges (DESIGN.md §10 of the JAX package): a NaN/Inf
    census, live edge-table entries, and the ``health_flags`` bitmask
    (nonfinite, out/in asymmetry, conservation against formed/deleted)."""
    neu = state.neurons
    f32 = torch.float32
    nonfinite = sum(
        torch.sum((~torch.isfinite(x)).to(f32))
        for x in (neu.v, neu.u, neu.calcium, neu.rate, state.positions))
    out_live = torch.sum((state.out_edges >= 0).to(f32))
    in_live = torch.sum((state.in_edges >= 0).to(f32))
    c = state.stats.counters
    formed, deleted = c["synapses_formed"][0], c["synapses_deleted"][0]
    clean = c["request_overflow"][0] == 0
    zero = torch.zeros((), dtype=f32, device=out_live.device)
    flags = torch.where(nonfinite > 0,
                        float(telemetry_metrics.HEALTH_NONFINITE), zero)
    flags = flags + torch.where(
        clean & (out_live != in_live),
        float(telemetry_metrics.HEALTH_ASYMMETRY), zero)
    live = out_live + in_live
    lo = 2.0 * formed - 2.0 * deleted
    hi = 2.0 * formed - deleted
    flags = flags + torch.where(
        clean & ((live < lo) | (live > hi)),
        float(telemetry_metrics.HEALTH_CONSERVATION), zero)
    return state.stats.set_gauges({
        "health_flags": flags, "nonfinite_state": nonfinite,
        "out_edges_live": out_live, "in_edges_live": in_live})


def sim_chunk(state, ctx: PhaseContext):
    """One chunk = one rate window (Delta activity steps) + one
    connectivity update; the chunk's counter increments go to the per-chunk
    ring and the health gauges are refreshed. Each phase runs under a
    ``record_function`` range of the reference's scope name, so a
    ``torch.profiler`` trace splits the chunk by phase."""
    start = {k: v.clone() for k, v in state.stats.counters.items()}
    with record_function("repro.activity"):
        state = activity_phase(state, ctx)
    with record_function("repro.connectivity"):
        state = connectivity_phase(state, ctx)
    stats = state.stats.record_chunk(start, state.chunk - 1)
    with record_function("repro.health"):
        stats = health_verdict(state._replace(stats=stats), ctx)
    return state._replace(stats=stats)
