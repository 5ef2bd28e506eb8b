"""The per-chunk connectivity update (paper phase 3):

  3a  deletion by retraction — element loss breaks bound synapses, partners
      are notified via routed messages and regain vacant elements;
  3b  formation — octree build, branch-node exchange, phase-A search over
      the replicated top tree, then the algorithm pair (registry domain
      "connectivity"): 'old' downloads every subtree and searches locally,
      'new' ships requests to the owning rank (routing.py);
  3c  rate refresh + the Delta-periodic rate exchange (registry domain
      "rate_exchange"): 'dense' all-gathers the replicated (R, n) table,
      'sparse' rebuilds the subscription registry from the just-updated
      in-edge table and the owners push only the subscribed rates. Under
      the old spike algorithm the rates are never read, and the exchange
      and its accounting are skipped, as in the reference.

A scenario's lesion mask applies before the algorithm branch: dead neurons
lose every synaptic element (a full retraction whose partners are
notified), neither search nor offer vacancies, and advertise rate 0.

Randomness: retraction and acceptance use chunk-keyed jax.random priorities
(``repro_torch.prng``), every Barnes-Hut draw the counter hash keyed by
(chunk, source gid) — the reference's streams. The chunk's keys are derived
on the host as u32 words (``prng.fold_in_words``, ``split_words``) from the
seed and the host-side chunk counter: nothing is copied to the card for
them; the reference lowering makes key tensors of them.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch import prng
from repro_torch.connectome import routing
from repro_torch.connectome import synapses as syn
from repro_torch.connectome import traverse
from repro_torch.connectome import tree as ctree
from repro_torch.core import morton, spikes
from repro_torch.core.neuron import refresh_rate
from repro_torch.scenarios import protocol as proto
from repro_torch.sim import registry


# ---------------------------------------------------------------- formation
@registry.register_phase("connectivity", "new")
def formation_phase_new(ctx, state, local_tree, vac_d_pos, out_edges,
                        in_edges, gids, branch_cell, owner, start_rel,
                        valid_a, k_accept, stats):
    """Paper's NEW algorithm: ship formation-and-calculation requests to the
    rank that owns the target subtree (move compute to the data)."""
    tgt_gid, accept, ovf, (depth, processed) = routing.formation_new(
        ctx.cfg, state.positions, local_tree, vac_d_pos, in_edges, gids,
        branch_cell, owner, start_rel, valid_a, ctx.comm, k_accept,
        state.chunk)
    in_edges = accept.pop("in_edges")
    stats = stats.count("request_overflow", ovf)
    stats = stats.count("bh_responses", torch.sum(accept["accepted"]))
    stats = ctx.metrics.traversal(stats, depth, processed)
    out_edges = syn.add_out_edges(out_edges, tgt_gid, accept["accepted"])
    stats = stats.count("synapses_formed", torch.sum(accept["accepted"]))
    return out_edges, in_edges, stats


@registry.register_phase("connectivity", "old")
def formation_phase_old(ctx, state, local_tree, vac_d_pos, out_edges,
                        in_edges, gids, branch_cell, owner, start_rel,
                        valid_a, k_accept, stats):
    """Paper's OLD baseline: download every remote subtree and its leaf
    neuron data, and finish the search locally."""
    tgt_gid, accepted, new_in, downloaded, (depth, searched) = \
        routing.formation_old(
            ctx.cfg, state.positions, local_tree, vac_d_pos, in_edges, gids,
            branch_cell, valid_a, ctx.comm, k_accept, state.chunk)
    out_edges = syn.add_out_edges(out_edges, tgt_gid, accepted)
    stats = stats.count("tree_nodes_downloaded", downloaded)
    # restart depths of this rank's searchers against the global tree
    stats = ctx.metrics.traversal(stats, depth, searched)
    stats = stats.count("synapses_formed", torch.sum(accepted))
    return out_edges, new_in, stats


# ---------------------------------------------------------------- exchange
@registry.register_phase("rate_exchange", "dense")
def exchange_dense(ctx, state, neurons, in_edges, stats):
    """All-gather every rank's full (n,) rate vector into the replicated
    (R, n) table — O(R*n) bytes per rank per Delta."""
    n = ctx.cfg.neurons_per_rank
    rates_table = spikes.exchange_rates(neurons.rate, ctx.comm)
    stats = stats.count("rates_sent", float(n * max(ctx.num_ranks - 1, 0)))
    return rates_table, state.subs, state.rate_slots, state.remote_rates, \
        stats


@registry.register_phase("rate_exchange", "sparse")
def exchange_sparse(ctx, state, neurons, in_edges, stats):
    """Demand-driven push: rebuild the subscription registry from the
    just-updated in-edge table, then the owners push exactly the subscribed
    rates — O(unique remote sources) instead of O(R*n)."""
    cfg, n = ctx.cfg, ctx.cfg.neurons_per_rank
    subs, rate_slots, ovf = spikes.build_subscriptions(
        in_edges, ctx.rank, n, routing.cap_subs(cfg, ctx.num_ranks))
    stats = stats.count("request_overflow", ovf)
    stats = stats.count("subscription_overflow", ovf)
    stats = ctx.metrics.subs_occupancy(stats, subs, spikes.NO_SUB)
    remote_rates, pushed = routing.push_subscribed_rates(
        subs, neurons.rate, ctx.comm, n)
    # one 4-byte request id out and one 4-byte rate back per subscription
    stats = stats.count("subscription_requests", pushed)
    stats = stats.count("rates_sent", pushed)
    return state.rates_table, subs, rate_slots, remote_rates, stats


# ---------------------------------------------------------------- update
def _retraction(state, ctx, gids, k_out, k_in, stats):
    """Phase 3a: break the synapses a neuron's lost elements no longer
    carry, route the notifications, and drain them out of the partners'
    tables. Returns (out_edges, in_edges, stats)."""
    cfg, comm = ctx.cfg, ctx.comm
    n = cfg.neurons_per_rank
    gid0 = ctx.rank * n
    out_edges, in_edges = state.out_edges, state.in_edges
    out_cnt, in_cnt = syn.counts(out_edges), syn.counts(in_edges)
    del_out = torch.clamp_min(
        out_cnt - torch.floor(state.neurons.ax_elements).to(torch.int32), 0)
    del_in = torch.clamp_min(
        in_cnt - torch.floor(state.neurons.de_elements).to(torch.int32), 0)
    apply_impl = registry.resolve("apply", cfg.apply_impl)
    out_edges, kill_out = apply_impl.retract(k_out, out_edges, del_out, gids)
    in_edges, kill_in = apply_impl.retract(k_in, in_edges, del_in, gids)
    stats = stats.count("synapses_deleted",
                        torch.sum(kill_out) + torch.sum(kill_in))

    # notify partners; kill masks index the PRE-retraction tables
    lesions = proto.has_lesions(ctx.scenario)
    msgs_out, ovf_out = apply_impl.route(
        kill_out, state.out_edges, gids[:, None], cfg, comm, lesions)
    msgs_in, ovf_in = apply_impl.route(
        kill_in, state.in_edges, gids[:, None], cfg, comm, lesions)
    stats = stats.count("request_overflow", ovf_out + ovf_in)
    # apply: partner of my out-edge removes its in-edge, and vice versa
    in_edges = apply_impl.deletion(
        in_edges, torch.clamp(msgs_out[:, 0] - gid0, 0, n - 1),
        msgs_out[:, 1],
        (msgs_out[:, 0] >= gid0) & (msgs_out[:, 0] < gid0 + n))
    out_edges = apply_impl.deletion(
        out_edges, torch.clamp(msgs_in[:, 0] - gid0, 0, n - 1),
        msgs_in[:, 1],
        (msgs_in[:, 0] >= gid0) & (msgs_in[:, 0] < gid0 + n))
    return out_edges, in_edges, stats


def connectivity_update(state, ctx):
    """One structural-plasticity update. Returns the state with ``chunk``
    advanced."""
    cfg, rank, num_ranks = ctx.cfg, ctx.rank, ctx.num_ranks
    n = cfg.neurons_per_rank
    dev = state.in_edges.device
    # rank-independent chunk key: every rank derives the same stream
    chunk_key = prng.fold_in_words(prng.key_words(cfg.seed + 2), state.chunk)
    gid0 = rank * n
    gids = gid0 + torch.arange(n, dtype=torch.int32, device=dev)
    stats = state.stats

    # lesion mask at the update instant (the step right after this chunk's
    # activity window); dead neurons lose all synaptic elements, so the
    # retraction below breaks all their synapses and notifies the partners
    alive = proto.alive_mask(ctx.events, ctx.regions, state.positions,
                             (state.chunk + 1) * cfg.rate_period) \
        if ctx.events else None
    if alive is not None:
        neu = state.neurons
        state = state._replace(neurons=neu._replace(
            ax_elements=torch.where(alive, neu.ax_elements, 0.0),
            de_elements=torch.where(alive, neu.de_elements, 0.0)))

    # ---- deletion by retraction (phase 3a) -------------------------------
    k_out, k_in, k_accept = prng.split_words(chunk_key, 3)
    with record_function("repro.conn.retraction"):
        out_edges, in_edges, stats = _retraction(state, ctx, gids, k_out,
                                                 k_in, stats)

    # ---- formation (phase 3b) --------------------------------------------
    out_cnt, in_cnt = syn.counts(out_edges), syn.counts(in_edges)
    vac_a = torch.floor(state.neurons.ax_elements).to(torch.int32) - out_cnt
    vac_d = state.neurons.de_elements - in_cnt.to(torch.float32)
    vac_d_pos = torch.clamp_min(vac_d, 0.0)

    with record_function("repro.conn.tree_build"):
        local_tree = ctree.build_tree(cfg, state.positions, vac_d_pos, rank,
                                      num_ranks)
        top = ctree.exchange_branch_nodes(local_tree, ctx.comm)
        stats = ctx.metrics.tree_built(stats, local_tree)

    searching = vac_a >= 1
    if alive is not None:
        # dead neurons neither search for partners nor offer vacancies
        searching = searching & alive
        vac_d_pos = torch.where(alive, vac_d_pos, 0.0)
    with record_function("repro.conn.phase_a"):
        branch_cell, valid_a = traverse.phase_a(top, state.positions, gids,
                                                cfg, num_ranks,
                                                chunk=state.chunk)
    valid_a = valid_a & searching
    c_per = morton.cells_per_rank(num_ranks)
    owner = torch.clamp(torch.div(branch_cell, c_per, rounding_mode="floor"),
                        0, num_ranks - 1)
    start_rel = branch_cell - owner * c_per
    stats = stats.count("bh_requests", torch.sum(valid_a))
    stats = stats.count("formation_requests", torch.sum(valid_a))

    formation = registry.resolve("connectivity", cfg.connectivity_alg)
    with record_function("repro.conn.formation"):
        out_edges, in_edges, stats = formation(
            ctx, state, local_tree, vac_d_pos, out_edges, in_edges, gids,
            branch_cell, owner, start_rel, valid_a, k_accept, stats)

    # ---- rate refresh + Delta-periodic exchange (phase 3c) ---------------
    neurons = refresh_rate(state.neurons, cfg, alive)
    rates_table, subs = state.rates_table, state.subs
    rate_slots, remote_rates = state.rate_slots, state.remote_rates
    if cfg.spike_alg != "old":
        exchange = registry.resolve("rate_exchange", cfg.rate_exchange)
        with record_function("repro.conn.exchange"):
            rates_table, subs, rate_slots, remote_rates, stats = exchange(
                ctx, state, neurons, in_edges, stats)
    return state._replace(neurons=neurons, out_edges=out_edges,
                          in_edges=in_edges, rates_table=rates_table,
                          subs=subs, rate_slots=rate_slots,
                          remote_rates=remote_rates,
                          chunk=state.chunk + 1, stats=stats)
