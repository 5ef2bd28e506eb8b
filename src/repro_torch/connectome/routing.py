"""Formation/deletion request routing and the sparse rate push — the
paper's byte-counted record exchanges (§IV-A, §IV-B):

OLD ("move data", ``formation_old``): the searching rank downloads every
rank's subtree and leaf neuron data (the all-gathers of the RMA+cache
endpoint), finishes the search locally, and sends a plain formation request
to the target's rank for accept or decline.

NEW ("move compute", ``formation_new``): the searching rank ships a
formation-and-calculation request to the rank owning the branch cell, which
finishes the search against its own subtree and answers.

Both run the same phase-B search against the same tree content, keyed to
the searcher's gid, so they form the same synapses. The sparse exchange's
``push_subscribed_rates`` ships each rank's subscriptions to the owners and
brings back exactly the subscribed rates.

The buffers are built exactly as the reference builds them and cross the
ranks through the rank's ``dist.Comm`` (tiled all-gathers and all-to-alls,
the identity at R=1).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.connectome import traverse
from repro_torch.connectome import tree as ctree
from repro_torch.core.spikes import NO_SUB
from repro_torch.sim import registry


def cap_requests(cfg, num_ranks: int):
    """Per-(source, dest)-rank request buffer capacity."""
    n = cfg.neurons_per_rank
    per_dest = max(n // max(num_ranks, 1), 1) * cfg.requests_cap_factor
    return min(n, max(32, -(-per_dest // 8) * 8))


def subs_base(cfg, num_ranks: int) -> int:
    """The per-rank unique-remote-source estimate the subscription registry
    is sized from: ``cfg.subs_cap_base`` when set, else ``n //
    num_ranks``."""
    if getattr(cfg, "subs_cap_base", None) is not None:
        return max(int(cfg.subs_cap_base), 32)
    return max(cfg.neurons_per_rank // max(num_ranks, 1), 32)


def cap_subs(cfg, num_ranks: int):
    """Subscription-registry capacity of the sparse rate exchange:
    ``subs_base`` x ``subs_cap_factor``, rounded up to 8, below the ceiling
    min(n * S, (R - 1) * n) (a rank cannot subscribe to more unique remote
    sources than it has in-edge slots or than exist remotely)."""
    n = cfg.neurons_per_rank
    full = min(n * cfg.max_synapses, max(num_ranks - 1, 1) * n)
    per = subs_base(cfg, num_ranks) * cfg.subs_cap_factor
    return int(min(full, max(32, -(-per // 8) * 8)))


def push_subscribed_rates(subs, rate, comm, n: int):
    """Sparse exchange, per-Delta push: ship each rank's subscriptions to the
    owner ranks and have the owners answer with exactly the subscribed
    rates (two tiled all-to-alls).

    ``subs``: (subs_cap,) sorted unique remote gids (``NO_SUB`` pad);
    ``rate``: (n,) this rank's rates. Returns ``(remote_rates, pushed)``:
    the (subs_cap,) rate buffer aligned with ``subs`` (0 on pads) and the
    number of rate records pushed to this rank."""
    num_ranks = comm.num_ranks
    subs_cap = subs.shape[0]
    dev = subs.device
    valid = subs != NO_SUB
    pushed = torch.sum(valid).to(torch.float32)
    if num_ranks == 1:
        return torch.zeros(subs_cap, dtype=torch.float32, device=dev), pushed
    owner = torch.where(valid, torch.div(subs, n, rounding_mode="floor"),
                        num_ranks)
    # subs is sorted, so the owners are contiguous and a slot below subs_cap
    slot = ctree.positions_within(owner, num_ranks + 1).to(torch.int64)
    # row num_ranks collects the pads' writes and is sliced off
    req = torch.full((num_ranks + 1, subs_cap), -1, dtype=torch.int32,
                     device=dev)
    req[owner.to(torch.int64), slot] = torch.where(
        valid, torch.remainder(subs, n), -1)
    with record_function("repro.comm.subscriptions"):
        req = comm.all_to_all(req[:num_ranks].contiguous())
    # req[p, j] is the local id rank p subscribed to: answer with its rate
    payload = torch.where(
        req >= 0, rate[torch.clamp(req, 0, n - 1).to(torch.int64)], 0.0)
    with record_function("repro.comm.subscriptions"):
        payload = comm.all_to_all(payload)
    # payload[o, j]: the rate of this rank's j-th subscription at owner o
    o = torch.where(valid, owner, 0).to(torch.int64)
    return torch.where(valid, payload[o, slot], 0.0), pushed


def cap_deletions(cfg, lesions: bool = False):
    """Deletion-message buffer capacity (lesion protocols retract every edge
    of a dead neuron at once, so the cap scales with requests_cap_factor)."""
    n = cfg.neurons_per_rank
    if not lesions:
        return max(16, n // 4)
    return min(n * cfg.max_synapses,
               max(16, (n // 4) * cfg.requests_cap_factor))


def route_build_core(flat_other, flat_mine, n: int, num_ranks: int, cap: int,
                     ranker):
    """Build the per-destination (num_ranks, cap, 2) notification buffers
    from the flattened (partner gid, my gid) pairs, with stable
    within-destination slot ranks from ``ranker(ids, buckets)``
    (``positions_within`` or ``bucket_ranks``: integer-identical). Row
    ``num_ranks`` of the scratch buffer collects the dropped writes (jax's
    ``mode="drop"``) and is sliced off: only the first ``num_ranks`` rows
    cross the all-to-all. Returns (buf, dropped count)."""
    valid = flat_other >= 0
    dest = torch.where(valid, torch.div(flat_other, n, rounding_mode="floor"),
                       num_ranks)
    slot = ranker(dest, num_ranks + 1)
    ok = valid & (slot < cap)
    buf = torch.full((num_ranks + 1, cap, 2), -1, dtype=torch.int32,
                     device=flat_other.device)
    buf[torch.where(ok, dest, num_ranks).to(torch.int64),
        torch.where(ok, slot, 0).to(torch.int64)] = torch.stack(
        [torch.where(ok, flat_other, -1), torch.where(ok, flat_mine, -1)],
        -1).to(torch.int32)
    return buf[:num_ranks].contiguous(), \
        torch.sum(valid & ~ok).to(torch.float32)


def exchange_deletions(buf, comm):
    """All-to-all the (num_ranks, cap, 2) notification buffers: the received
    (num_ranks * cap, 2) messages, rank-major."""
    with record_function("repro.comm.deletions"):
        buf = comm.all_to_all(buf)
    return buf.reshape(-1, 2)


def route_deletions(kill, edges, my_gid_col, cfg, comm, lesions: bool):
    """All-to-all the (partner gid, my gid) retraction notifications.
    Returns the received (num_ranks * cap, 2) messages and the dropped
    count."""
    n = cfg.neurons_per_rank
    flat_other = torch.where(kill, edges, -1).reshape(-1)
    flat_mine = torch.broadcast_to(my_gid_col, kill.shape).reshape(-1)
    cap = cap_deletions(cfg, lesions)
    buf, dropped = route_build_core(flat_other, flat_mine, n, comm.num_ranks,
                                    cap, ctree.positions_within)
    return exchange_deletions(buf, comm), dropped


def formation_new(cfg, positions, local_tree, vacant_d, in_edges, gids,
                  branch_cell, owner, start_rel, valid_a, comm, key,
                  chunk: int):
    """Location-aware algorithm: requests out (two all-to-alls), local
    phase B + accept, responses back (one). Returns (tgt_gid, accept dict,
    overflow count, (depth, processed))."""
    rank, num_ranks = comm.rank, comm.num_ranks
    n = cfg.neurons_per_rank
    dev = positions.device
    cap = cap_requests(cfg, num_ranks)
    dest = torch.where(valid_a, owner, num_ranks)
    slot = ctree.positions_within(dest, num_ranks + 1)
    ok = valid_a & (slot < cap)
    ovf = torch.sum(valid_a & ~ok).to(torch.float32)

    # rows past num_ranks collect the dropped writes and are sliced off
    ibuf = torch.full((num_ranks + 1, cap, 2), -1, dtype=torch.int32,
                      device=dev)                          # src_gid, start
    fbuf = torch.zeros((num_ranks + 1, cap, 3), dtype=torch.float32,
                       device=dev)                         # position
    d_c = torch.where(ok, dest, num_ranks).to(torch.int64)
    s_c = torch.where(ok, slot, 0).to(torch.int64)
    ibuf[d_c, s_c] = torch.stack([torch.where(ok, gids, -1),
                                  start_rel.to(gids.dtype)], -1).to(
        torch.int32)
    fbuf[d_c, s_c] = positions
    # only the first num_ranks rows cross: row d goes to rank d, and the
    # received row s holds rank s's requests (rank-major slot order)
    with record_function("repro.comm.formation_requests"):
        ibuf = comm.all_to_all(ibuf[:num_ranks].contiguous())
        fbuf = comm.all_to_all(fbuf[:num_ranks].contiguous())

    r_src = ibuf[..., 0].reshape(-1)
    r_cell = ibuf[..., 1].reshape(-1)
    r_pos = fbuf.reshape(-1, 3)
    r_valid = r_src >= 0
    # the receiver re-derives the searcher's Gumbel stream from its gid
    tgt, bvalid, depth = traverse.phase_b(
        local_tree, positions, vacant_d, r_pos,
        torch.where(r_valid, r_src, -2), torch.clamp_min(r_cell, 0), r_valid,
        cfg, num_ranks, rank * n, chunk=chunk)
    apply_impl = registry.resolve("apply", cfg.apply_impl)
    acc, new_in = apply_impl.accept(
        torch.clamp(tgt - rank * n, 0, n - 1), r_src, bvalid & (tgt >= 0),
        vacant_d, in_edges, key)
    # responses retrace the request route
    rbuf = torch.stack([torch.where(acc, tgt, -1), acc.to(torch.int32)],
                       -1).reshape(num_ranks, cap, 2)
    with record_function("repro.comm.formation_responses"):
        rbuf = comm.all_to_all(rbuf)
    # row d now holds rank d's answers to my requests there; the dropped
    # requests (row num_ranks) read row num_ranks - 1 and are masked by ok
    d_g = torch.clamp(d_c, max=num_ranks - 1)
    resp_tgt = rbuf[d_g, s_c, 0]
    resp_ok = (rbuf[d_g, s_c, 1] > 0) & ok
    return resp_tgt, {"accepted": resp_ok, "in_edges": new_in}, ovf, \
        (depth, r_valid)


def formation_old(cfg, positions, local_tree, vacant_d, in_edges, gids,
                  branch_cell, valid_a, comm, key, chunk: int):
    """Baseline: download every rank's subtree and leaf data, search
    locally, then exchange plain formation requests. Returns (tgt_gid,
    accepted, new_in_edges, downloaded node count, (depth, searched))."""
    rank, num_ranks = comm.rank, comm.num_ranks
    n = cfg.neurons_per_rank
    dev = positions.device
    # ---- the download: all levels, members, positions, vacancies ----
    if num_ranks > 1:
        with record_function("repro.comm.tree_download"):
            g_counts = tuple(comm.all_gather(c) for c in local_tree.counts)
            g_cents = tuple(comm.all_gather(z)
                            for z in local_tree.centroids)
            members = local_tree.leaf_members
            g_members = comm.all_gather(
                torch.where(members >= 0, members + rank * n, -1))
            g_pos = comm.all_gather(positions)
            g_vac = comm.all_gather(vacant_d)
    else:
        g_counts, g_cents = local_tree.counts, local_tree.centroids
        g_members = local_tree.leaf_members
        g_pos, g_vac = positions, vacant_d
    downloaded = (sum(c.shape[0] for c in g_counts) + g_pos.shape[0]) \
        * (num_ranks - 1) / max(num_ranks, 1)
    g_tree = ctree.LocalTree(g_counts, g_cents, g_members, 0)
    # ---- phase B locally for my searchers (the same streams as 'new') ----
    tgt, bvalid, depth = traverse.phase_b(g_tree, g_pos, g_vac, positions,
                                          gids, branch_cell, valid_a, cfg,
                                          num_ranks, 0, chunk=chunk)
    # ---- a plain formation request to the target's rank ----
    cap = cap_requests(cfg, num_ranks)
    dest = torch.where(bvalid & (tgt >= 0),
                       torch.div(tgt, n, rounding_mode="floor"), num_ranks)
    slot = ctree.positions_within(dest, num_ranks + 1)
    ok = (dest < num_ranks) & (slot < cap)
    # row num_ranks collects the dropped writes and is sliced off
    ibuf = torch.full((num_ranks + 1, cap, 2), -1, dtype=torch.int32,
                      device=dev)
    d_c = torch.where(ok, dest, num_ranks).to(torch.int64)
    s_c = torch.where(ok, slot, 0).to(torch.int64)
    ibuf[d_c, s_c] = torch.stack([torch.where(ok, gids, -1),
                                  torch.where(ok, tgt, -1)], -1).to(
        torch.int32)
    with record_function("repro.comm.formation_requests"):
        ibuf = comm.all_to_all(ibuf[:num_ranks].contiguous())
    r_src = ibuf[..., 0].reshape(-1)
    r_tgt = ibuf[..., 1].reshape(-1)
    r_valid = (r_src >= 0) & (r_tgt >= 0)
    apply_impl = registry.resolve("apply", cfg.apply_impl)
    acc, new_in = apply_impl.accept(
        torch.clamp(r_tgt - rank * n, 0, n - 1), r_src, r_valid, vacant_d,
        in_edges, key)
    rbuf = acc.to(torch.int32).reshape(num_ranks, cap)
    with record_function("repro.comm.formation_responses"):
        rbuf = comm.all_to_all(rbuf)
    # the dropped requests (row num_ranks) read row num_ranks - 1, masked
    accepted = (rbuf[torch.clamp(d_c, max=num_ranks - 1), s_c] > 0) & ok
    return tgt, accepted, new_in, downloaded, (depth, valid_a)
