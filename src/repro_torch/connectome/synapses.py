"""Synapse-table ops: the (n, S_max) out/in edge tables and everything that
mutates them — accept, add, retract, compact, message-driven removal.

Vectorized as in the JAX package (segment ranks via stable sorts and
cumsums). ``jnp.lexsort`` becomes chained stable ``torch.argsort`` calls, and
a ``scatter(mode="drop")`` becomes a write into a table with one extra trash
row or column that is sliced off (dropped writes may collide there only).
Randomized choices use keyed per-(row, partner) priorities
(``edge_priority``: the reference's jax.random draws, ``repro_torch.prng``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import prng
from repro_torch.connectome.tree import positions_within
from repro_torch.sim import registry


def counts(edges):
    return torch.sum(edges >= 0, dim=1, dtype=torch.int32)


def compact(edges):
    """Push occupied slots to the front of each row (stable)."""
    n, s_max = edges.shape
    occ = edges >= 0
    dst = torch.cumsum(occ, dim=1) - 1
    out = torch.full((n, s_max + 1), -1, dtype=edges.dtype,
                     device=edges.device)
    out.scatter_(1, torch.where(occ, dst, s_max), edges)
    return out[:, :s_max].contiguous()


def lexsort(keys):
    """``jnp.lexsort``: the LAST key is the primary one. Chained stable
    argsorts, least significant key first."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def edge_priority(key, a_gid, b_gid):
    """Deterministic per-(a,b) uniform — ``uniform(fold_in(fold_in(key, a),
    b))`` for every pair, independent of buffer ordering. ``key``: a key
    tensor or two u32 words. On the card three launches of K0's draw kernel,
    nothing cast or copied between them."""
    return prng.uniform(prng.fold_in(prng.fold_in(key, a_gid), b_gid))


def accept_core(tgt_lid, src_gid, valid, vacant_d, in_edges, prio):
    """Acceptance with the per-request priorities precomputed: each target
    accepts up to min(floor(vacant), free slots) requests, lowest priority
    first, written after its occupied slots."""
    n, s_max = in_edges.shape
    q = tgt_lid.shape[0]
    lid = torch.where(valid, tgt_lid, n)                  # bucket n = invalid
    order = lexsort((prio, lid))
    rank_p = positions_within(lid[order], n + 1)
    rank_in_tgt = torch.empty(q, dtype=torch.int32, device=lid.device)
    rank_in_tgt[order] = rank_p
    lid_c = torch.clamp(lid, 0, n - 1).to(torch.int64)
    base = counts(in_edges)
    free = s_max - base
    cap = torch.minimum(
        torch.floor(torch.where(valid, vacant_d[lid_c], 0.0)),
        free[lid_c].to(torch.float32))
    accept = valid & (rank_in_tgt < cap)
    slot = torch.where(accept, base[lid_c] + rank_in_tgt, s_max)
    new_in = torch.cat([in_edges, torch.full((n, 1), -1, dtype=in_edges.dtype,
                                             device=in_edges.device)], 1)
    new_in[lid_c, slot.to(torch.int64)] = torch.where(
        accept, src_gid.to(in_edges.dtype), -1)
    return accept, new_in[:, :s_max].contiguous()


def request_priority(key, tgt_lid, src_gid, valid):
    """Keyed per-(src, tgt) acceptance priorities of a request buffer
    (invalid rows draw the (0, 0) stream — never accepted)."""
    return edge_priority(key, torch.where(valid, src_gid, 0),
                         torch.where(valid, tgt_lid, 0))


def accept_requests(tgt_lid, src_gid, valid, vacant_d, in_edges, key):
    """Targets accept as many requests as they have vacant dendritic
    elements (random subset by keyed priority). Returns (accept (Q,) bool,
    new in_edges)."""
    prio = request_priority(key, tgt_lid, src_gid, valid)
    return accept_core(tgt_lid, src_gid, valid, vacant_d, in_edges, prio)


def add_out_edges(out_edges, tgt_gid, accept):
    """Write accepted targets into the source neurons' out-edge tables
    (one pending request per source neuron)."""
    n, s_max = out_edges.shape
    base = counts(out_edges)
    slot = torch.where(accept & (base < s_max), base, s_max)
    out = torch.cat([out_edges, torch.full((n, 1), -1, dtype=out_edges.dtype,
                                           device=out_edges.device)], 1)
    rows = torch.arange(n, device=out_edges.device)
    out[rows, slot.to(torch.int64)] = torch.where(
        accept, tgt_gid.to(out_edges.dtype), -1)
    return out[:, :s_max].contiguous()


def retract_synapses(key, edges, n_delete, row_gids):
    """Randomly break ``n_delete[i]`` bound synapses of neuron i: the
    ``n_delete[i]`` lowest-priority occupied slots, ranked with (priority,
    slot) lexicographic ties over the (S, S) pairwise comparisons. Returns
    (new_edges, kill mask)."""
    n, s_max = edges.shape
    occupied = edges >= 0
    flat_prio = edge_priority(
        key, torch.broadcast_to(row_gids[:, None], edges.shape).reshape(-1),
        torch.where(occupied, edges, 0).reshape(-1))
    prio = torch.where(occupied, flat_prio.reshape(edges.shape), 2.0)
    lt = prio[:, :, None] < prio[:, None, :]
    ar = torch.arange(s_max, device=edges.device)
    tie = (prio[:, :, None] == prio[:, None, :]) & \
        (ar[:, None] < ar[None, :])
    ranks = torch.sum(lt | tie, dim=1)
    kill = occupied & (ranks < n_delete[:, None])
    return torch.where(kill, -1, edges), kill


def remove_edges_by_messages(edges, msg_lid, msg_gid, msg_valid):
    """Remove one occurrence of msg_gid from row msg_lid per message,
    earliest slots first (the sequential drain semantics), in one pass of
    lexsorted (row, value) groups with messages leading."""
    n, s_max = edges.shape
    q = msg_lid.shape[0]
    dev = edges.device
    e_flat = edges.reshape(-1)
    e_idx = torch.arange(n * s_max, dtype=torch.int32, device=dev)
    i32 = torch.int32
    rows = torch.cat([torch.where(msg_valid, msg_lid, n).to(i32),
                      torch.where(e_flat >= 0, e_idx // s_max, n + 1)])
    vals = torch.cat([msg_gid.to(i32), e_flat.to(i32)])
    is_edge = torch.cat([torch.zeros(q, dtype=torch.bool, device=dev),
                         torch.ones(n * s_max, dtype=torch.bool, device=dev)])
    slot = torch.cat([torch.zeros(q, dtype=i32, device=dev), e_idx % s_max])
    order = lexsort((slot, is_edge.to(i32), vals, rows))
    r_s, v_s, e_s = rows[order], vals[order], is_edge[order]
    k = torch.arange(rows.shape[0], device=dev)
    newgrp = (k == 0) | (r_s != torch.roll(r_s, 1)) | \
        (v_s != torch.roll(v_s, 1))
    start = torch.cummax(torch.where(newgrp, k, 0), dim=0).values
    is_msg = (~e_s).to(torch.int64)
    mcum = torch.cumsum(is_msg, dim=0)
    m_group = mcum - (mcum[start] - is_msg[start])
    occ_rank = (k - start) - m_group
    kill_sorted = e_s & (occ_rank < m_group)
    kill = torch.empty(q + n * s_max, dtype=torch.bool, device=dev)
    kill[order] = kill_sorted
    return torch.where(kill[q:].reshape(n, s_max), -1, edges)


# ------------------------------------------------------------ apply registry
class ApplyImpl(NamedTuple):
    """One registered implementation of the synapse-apply stages (registry
    domain "apply"): ``deletion`` drains routed retraction messages out of
    one edge table and re-compacts it; ``accept`` admits formation requests;
    ``route`` builds the per-destination deletion-notification buffers;
    ``retract`` breaks the synapses that lost elements no longer carry.
    'reference' runs the plain torch ops above; 'fused' runs K4 and K5
    (``kernels/synapse_apply.py``), one stage per kernel pass, and the
    retraction and acceptance priorities of ``kernels/retract.py``. Keys are
    key tensors or two u32 words (the fused entries take the words by
    value)."""
    deletion: Callable   # (edges, msg_lid, msg_gid, msg_valid)
    accept: Callable     # (tgt_lid, src_gid, valid, vacant_d, in_edges, key)
    route: Callable      # (kill, edges, my_gid_col, cfg, comm, lesions)
    retract: Callable    # (key, edges, n_delete, row_gids)


def _deletion_reference(edges, msg_lid, msg_gid, msg_valid):
    return compact(remove_edges_by_messages(edges, msg_lid, msg_gid,
                                            msg_valid))


def _route_reference(kill, edges, my_gid_col, cfg, comm, lesions):
    from repro_torch.connectome import routing  # lazy: routing imports us
    return routing.route_deletions(kill, edges, my_gid_col, cfg, comm,
                                   lesions)


def _deletion_fused(edges, msg_lid, msg_gid, msg_valid):
    """K4 with the accept stage disabled (no valid requests): the table
    leaves the kernel after remove + compact."""
    from repro_torch.kernels import synapse_apply as ksa  # lazy: imports us
    n = edges.shape[0]
    dev = edges.device
    zi = torch.zeros(8, dtype=torch.int32, device=dev)
    new_edges, _ = ksa.synapse_apply(
        edges, msg_lid, msg_gid, msg_valid, zi, zi,
        torch.zeros(8, dtype=torch.bool, device=dev),
        torch.zeros(8, dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.float32, device=dev))
    return new_edges


def _accept_fused(tgt_lid, src_gid, valid, vacant_d, in_edges, key):
    """K4 with the deletion stage disabled (no valid messages). The
    priorities are ``request_priority``'s, drawn before the kernel by
    ``kernels/retract.py::edge_priority``; the table (compacted on entry)
    passes remove + compact unchanged."""
    from repro_torch.kernels import retract as kr  # lazy: imports us
    from repro_torch.kernels import synapse_apply as ksa  # lazy: imports us
    prio = kr.edge_priority(key, src_gid, tgt_lid, valid)
    dev = in_edges.device
    zi = torch.zeros(8, dtype=torch.int32, device=dev)
    new_in, acc = ksa.synapse_apply(
        in_edges, zi, zi, torch.zeros(8, dtype=torch.bool, device=dev),
        tgt_lid, src_gid, valid, prio, vacant_d)
    return acc, new_in


def _route_fused(kill, edges, my_gid_col, cfg, comm, lesions):
    """K5 builds the per-destination notification buffers, which then cross
    the ranks in one all-to-all."""
    from repro_torch.connectome import routing  # lazy: routing imports us
    from repro_torch.kernels import synapse_apply as ksa  # lazy: imports us
    cap = routing.cap_deletions(cfg, lesions)
    flat_other = torch.where(kill, edges, -1).reshape(-1)
    flat_mine = torch.broadcast_to(my_gid_col, kill.shape).reshape(-1)
    buf, dropped = ksa.route_build(flat_other, flat_mine,
                                   n=cfg.neurons_per_rank,
                                   num_ranks=comm.num_ranks, cap=cap)
    return routing.exchange_deletions(buf, comm), dropped[0]


def _retract_fused(key, edges, n_delete, row_gids):
    from repro_torch.kernels import retract as kr  # lazy: imports us
    return kr.retract(key, edges, n_delete, row_gids)


registry.register_phase("apply", "reference")(
    ApplyImpl(_deletion_reference, accept_requests, _route_reference,
              retract_synapses))
registry.register_phase("apply", "fused")(
    ApplyImpl(_deletion_fused, _accept_fused, _route_fused, _retract_fused))
