"""PhaseContext + the engine-level phase implementations.

``PhaseContext`` bundles what every phase needs besides the state (config,
rank, rank count, the rank's ``dist.Comm``, the scenario with its region and
event tuples, the population table, the metrics recorder). The activity
lowerings and the per-step spike exchanges register here; the connectivity,
traversal, tree, apply and rate-exchange lowerings register next to their
implementations in ``repro_torch.connectome``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import dist
from repro_torch.connectome.update import connectivity_update
from repro_torch.core import spikes
from repro_torch.kernels import activity_fused
from repro_torch.scenarios import populations as pops
from repro_torch.scenarios import protocol as proto
from repro_torch.scenarios import regions as regions_mod
from repro_torch.sim import registry
from repro_torch.telemetry import metrics as telemetry_metrics


class DynamicParams(NamedTuple):
    """Runtime parameters a host loop may change between chunks
    (``Simulator.step_with``). Every leaf is a tensor on the simulator's
    device whose values reach the kernels by pointer, so new values need no
    rebuild; only a leaf of another shape, dtype or device is a new
    signature (``Simulator.dyn_compile_count``).

    ``region_drive``: (num_buckets,) f32 additive offset on the background
    drive MEAN per region bucket (``regions.assign_regions`` order: named
    regions first, the trailing 'rest' bucket last). It rides on
    ``bg_mean``, already a per-neuron operand of both activity lowerings."""
    region_drive: Any

    @staticmethod
    def zeros(num_buckets: int, device=None) -> "DynamicParams":
        return DynamicParams(region_drive=torch.zeros(
            num_buckets, dtype=torch.float32, device=device))


@dataclass
class PhaseContext:
    """Everything a phase implementation needs besides the BrainState.
    ``comm`` is the rank's ``dist.Comm`` (its rank and rank count are
    ``rank`` and ``num_ranks``); ``dyn`` the ``DynamicParams`` of a
    ``step_with`` chunk (None on ``step`` and ``run``)."""
    cfg: Any
    rank: int
    num_ranks: int
    scenario: Any = None
    table: Any = None
    regions: Tuple = ()
    events: Tuple = ()
    metrics: Any = None
    comm: Any = dist.SINGLE
    dyn: Optional[DynamicParams] = None


def make_context(cfg, rank: int, num_ranks: int, scenario=None,
                 device=None, comm=None) -> PhaseContext:
    """The context of rank ``rank`` of ``num_ranks``; ``comm`` may be left
    out at one rank (every collective is then the identity)."""
    if comm is None:
        if num_ranks != 1:
            raise ValueError(f"make_context: {num_ranks} ranks need the "
                             f"rank's dist.Comm")
        comm = dist.SINGLE
    if (comm.rank, comm.num_ranks) != (rank, num_ranks):
        raise ValueError(f"make_context: rank {rank} of {num_ranks} with the "
                         f"comm of rank {comm.rank} of {comm.num_ranks}")
    table = pops.table_for(cfg, scenario, cfg.neurons_per_rank, device=device)
    regions = scenario.regions if scenario is not None else ()
    events = scenario.events if scenario is not None else ()
    return PhaseContext(cfg=cfg, rank=rank, num_ranks=num_ranks,
                        scenario=scenario, table=table, regions=regions,
                        events=events,
                        metrics=telemetry_metrics.Recorder(
                            n=cfg.neurons_per_rank), comm=comm)


# ================================================================ activity
def _window_inputs(state, ctx: PhaseContext):
    """The per-window tables: Izhikevich parameters, background drive
    (region overrides), the protocol's stimulus and lesion tables, and the
    rate view of the exchange layout (dense: the replicated (R, n) table;
    sparse: the compact subscribed-rate buffer through the (n, S) edge ->
    slot remap)."""
    cfg, table = ctx.cfg, ctx.table
    izh = (table.izh_a, table.izh_b, table.izh_c, table.izh_d,
           table.growth_rate, table.target_calcium)
    bg_mean, bg_std = regions_mod.background_tables(state.positions,
                                                    ctx.regions, cfg)
    if ctx.dyn is not None:
        # the dynamic per-region drive: lift bg_mean to (n,) and add each
        # neuron's bucket offset (one f32 add), as the reference does; both
        # lowerings take bg_mean as an (n,) operand
        rid = regions_mod.assign_regions(state.positions, ctx.regions)
        if isinstance(bg_mean, torch.Tensor):
            base = bg_mean.to(torch.float32)
        else:
            base = torch.full(rid.shape, bg_mean, dtype=torch.float32,
                              device=rid.device)
        bg_mean = base + ctx.dyn.region_drive[rid.to(torch.int64)]
    stim = proto.stim_tables(ctx.events, ctx.regions, state.positions) \
        if ctx.events else None
    lesions = proto.lesion_tables(ctx.events, ctx.regions, state.positions) \
        if ctx.events else None
    if cfg.rate_exchange == "sparse":
        rates, rate_slots = state.remote_rates, state.rate_slots
    else:
        rates, rate_slots = state.rates_table, None
    return rates, bg_mean, bg_std, dict(
        seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
        ca_consts=(cfg.calcium_decay, cfg.calcium_beta), stim=stim,
        lesions=lesions, rate_slots=rate_slots)


def _st7(neurons):
    return (neurons.v, neurons.u, neurons.calcium, neurons.ax_elements,
            neurons.de_elements, neurons.spiked, neurons.spike_count)


def _unpack_st7(neurons, out):
    return neurons._replace(v=out[0], u=out[1], calcium=out[2],
                            ax_elements=out[3], de_elements=out[4],
                            spiked=out[5], spike_count=out[6])


@registry.register_phase("spikes", "old")
def spikes_old(st7, state, ctx: PhaseContext, stats):
    """OLD spike transmission, one step: all-gather the sorted spiked-ID
    lists, binary-search each remote in-edge. Returns the (n, S) remote
    hits; counts the step's spiked IDs into ``spikes_sent``."""
    n = ctx.cfg.neurons_per_rank
    all_ids, _ = spikes.exchange_spiked_ids(st7[5], ctx.rank, n, ctx.comm)
    hits = spikes.lookup_spikes(all_ids, state.in_edges, n)
    remote_in = hits & (torch.div(state.in_edges, n, rounding_mode="floor")
                        != ctx.rank) & (state.in_edges >= 0)
    stats = stats.count("spikes_sent", torch.sum(st7[5]))
    return remote_in, stats


@registry.register_phase("spikes", "new")
def spikes_new(st7, state, ctx: PhaseContext, stats):
    """NEW spike transmission: no per-step exchange — step_core rebuilds
    remote spikes from the counter hash and the exchanged rates."""
    return None, stats


def _activity(state, ctx: PhaseContext, window, **extra):
    rates, bg_mean, bg_std, kw = _window_inputs(state, ctx)
    out, spikes_per_step = window(
        _st7(state.neurons), state.in_edges, ctx.table.synapse_weight,
        rates, bg_mean, bg_std, state.chunk, ctx.rank, **kw, **extra)
    stats = ctx.metrics.activity_window(state.stats, spikes_per_step)
    return state._replace(neurons=_unpack_st7(state.neurons, out),
                          stats=stats)


@registry.register_phase("activity", "reference")
def activity_reference(state, ctx: PhaseContext):
    """Delta iterations of the plain torch ``step_core``; under the old
    spike algorithm each step first runs its spike exchange (a collective)
    and takes its remote hits, counting ``spikes_sent`` a step."""
    exchange = registry.resolve("spikes", ctx.cfg.spike_alg)
    return _activity(state, ctx, activity_fused.window_plain,
                     remote=lambda st: exchange(st, state, ctx,
                                                state.stats)[0])


@registry.register_phase("activity", "fused")
def activity_fused_phase(state, ctx: PhaseContext):
    """The activity window kernel K1 (one launch per window). Needs
    spike_alg='new' (``registry.check_config``): the old algorithm's
    per-step spiked-ID exchange cannot run inside the window kernel."""
    return _activity(state, ctx, activity_fused.activity_window)


def activity_phase(state, ctx: PhaseContext):
    return registry.resolve("activity", ctx.cfg.activity_impl)(state, ctx)


def connectivity_phase(state, ctx: PhaseContext):
    return connectivity_update(state, ctx)


# ================================================================ health
def health_verdict(state, ctx: PhaseContext):
    """The health gauges (DESIGN.md §10 of the JAX package): a NaN/Inf
    census, live edge-table entries, and the ``health_flags`` bitmask
    (nonfinite, out/in asymmetry, conservation against formed/deleted),
    judged on the six-element vector summed over ranks (one psum), so
    ``health_flags`` is the same on every rank; the census gauges stay
    the rank's own."""
    neu = state.neurons
    f32 = torch.float32
    nonfinite = sum(
        torch.sum((~torch.isfinite(x)).to(f32))
        for x in (neu.v, neu.u, neu.calcium, neu.rate, state.positions))
    out_live = torch.sum((state.out_edges >= 0).to(f32))
    in_live = torch.sum((state.in_edges >= 0).to(f32))
    c = state.stats.counters
    local = torch.stack([nonfinite, out_live, in_live,
                         c["synapses_formed"][0], c["synapses_deleted"][0],
                         c["request_overflow"][0]])
    with record_function("repro.comm.health"):
        g = ctx.comm.psum(local)
    g_nf, g_out, g_in, formed, deleted, overflow = (g[i] for i in range(6))
    clean = overflow == 0
    zero = torch.zeros((), dtype=f32, device=out_live.device)
    flags = torch.where(g_nf > 0,
                        float(telemetry_metrics.HEALTH_NONFINITE), zero)
    flags = flags + torch.where(
        clean & (g_out != g_in),
        float(telemetry_metrics.HEALTH_ASYMMETRY), zero)
    live = g_out + g_in
    lo = 2.0 * formed - 2.0 * deleted
    hi = 2.0 * formed - deleted
    flags = flags + torch.where(
        clean & ((live < lo) | (live > hi)),
        float(telemetry_metrics.HEALTH_CONSERVATION), zero)
    return state.stats.set_gauges({
        "health_flags": flags, "nonfinite_state": nonfinite,
        "out_edges_live": out_live, "in_edges_live": in_live})


def probe_flags(state, ctx: PhaseContext) -> torch.Tensor:
    """The ``health_flags`` gauge that ``health_verdict`` gives the state
    as it is now, judged into copies of the gauges, so the state keeps the
    last chunk's verdict. Every rank calls it (the verdict psums)."""
    gauges = {k: v.clone() for k, v in state.stats.gauges.items()}
    probe = state._replace(stats=replace(state.stats, gauges=gauges))
    return health_verdict(probe, ctx).gauges["health_flags"]


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
