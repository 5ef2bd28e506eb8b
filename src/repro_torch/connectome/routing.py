"""Formation/deletion request routing — the paper's byte-counted record
exchanges (§IV-A), NEW algorithm ("move compute"): the searching rank ships
a formation-and-calculation request to the rank owning the branch cell,
which finishes the search against its own subtree and answers.

The buffers are built exactly as the reference builds them and cross the
ranks through the rank's ``dist.Comm`` (tiled all-to-alls, the identity at
R=1). ``formation_old`` comes with ROADMAP.md Queue 1 item 9.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.connectome import traverse
from repro_torch.connectome import tree as ctree
from repro_torch.sim import registry


def cap_requests(cfg, num_ranks: int):
    """Per-(source, dest)-rank request buffer capacity."""
    n = cfg.neurons_per_rank
    per_dest = max(n // max(num_ranks, 1), 1) * cfg.requests_cap_factor
    return min(n, max(32, -(-per_dest // 8) * 8))


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
