"""Spike transmission (paper §IV-B): the OLD per-step spiked-ID exchange with
a binary-search lookup, and the NEW Delta-periodic rate exchange with the
counter-hash reconstruction, in its dense and sparse layouts.

Old (every step): the ranks all-gather the sorted gids of the neurons that
fired (``exchange_spiked_ids``); each receiver binary-searches every remote
in-edge's source in its owner's list (``lookup_spikes``).

New (every Delta): the ranks exchange per-neuron rates; between exchanges
each receiver draws Bernoulli(rate) per remote edge from the counter hash
keyed by ``(seed, step, edge)``. Local edges always see true spikes. The
dense layout all-gathers every rank's rates into the replicated (R, n)
table; the sparse layout derives a per-rank subscription registry from the
in-edge table (``build_subscriptions``: the sorted unique remote source
gids, and the edge -> slot remap) and the owners push only the subscribed
rates (``connectome.routing.push_subscribed_rates``).

The JAX package runs these with ``jnp.sort``, ``jnp.searchsorted`` and a
``fori_loop`` binary search, no Pallas kernel, so their counterparts here
are plain torch (``torch.sort``, ``torch.searchsorted`` and the same
explicit binary search) on whatever device the tensors lie. Every
collective goes through the rank's ``dist.Comm`` (the identity at R=1).
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.kernels.activity_fused import (local_spike_hits,
                                                reconstruct_remote_spikes)

NO_SUB = 2 ** 31 - 1     # registry pad, int32 max (sorts after every gid)


def _rank_of(gids, n: int):
    return torch.div(gids, n, rounding_mode="floor")


def exchange_spiked_ids(spiked, rank: int, n: int, comm):
    """OLD algorithm, send side. spiked: (n,) bool. Returns (ids (R, n)
    int32, each rank's spiked gids sorted and padded with int32 max, counts
    (R,) int32): one all-gather of the ids with the count appended."""
    dev = spiked.device
    gid = rank * n + torch.arange(n, dtype=torch.int32, device=dev)
    ids = torch.sort(torch.where(spiked, gid, NO_SUB)).values
    count = torch.sum(spiked.to(torch.int32)).to(torch.int32)
    with record_function("repro.comm.spikes"):
        both = comm.all_gather(torch.cat([ids, count[None]])[None])
    return both[:, :n], both[:, n]


def lookup_spikes(all_ids, in_edges, n: int):
    """OLD algorithm, receive side: binary-search each in-edge's source gid
    in its owner's sorted spiked-ID list (the reference's explicit search,
    ceil(log2(n_ids)) + 1 halvings). in_edges: (n, S) source gids (-1
    empty). Returns (n, S) bool."""
    src = in_edges
    valid = src >= 0
    src_rank = torch.where(valid, _rank_of(src, n), 0)
    n_ids = all_ids.shape[1]
    flat = all_ids.reshape(-1)
    base = src_rank.to(torch.int64) * n_ids
    lo = torch.zeros(src.shape, dtype=torch.int32, device=src.device)
    hi = torch.full(src.shape, n_ids, dtype=torch.int32, device=src.device)
    for _ in range(int(math.ceil(math.log2(max(n_ids, 2)))) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = flat[base + torch.clamp(mid, 0, n_ids - 1)]
        go_right = v < src
        lo, hi = torch.where(go_right, mid + 1, lo), \
            torch.where(go_right, hi, mid)
    v = flat[base + torch.clamp(lo, 0, n_ids - 1)]
    return valid & (v == src)


def exchange_rates(rate, comm):
    """NEW algorithm, send side (every Delta steps): all-gather every rank's
    (n,) rates into the (R, n) table, rows in rank order."""
    with record_function("repro.comm.rates"):
        return comm.all_gather(rate[None])


def build_subscriptions(in_edges, rank: int, n: int, subs_cap: int):
    """Sparse exchange, receive side: this rank's subscription registry,
    derived from its in-edge table (rank-local, once a connectivity update).

    Returns ``(subs, rate_slots, overflow)``: ``subs`` (subs_cap,) int32,
    the sorted unique REMOTE source gids, padded with ``NO_SUB``;
    ``rate_slots`` (n, S) int32, each in-edge's index into ``subs`` (and the
    pushed-rate buffer aligned with it), -1 for local, empty or overflowed
    edges; ``overflow`` f32, the unique remote sources that did not fit."""
    dev = in_edges.device
    src = in_edges.reshape(-1)
    remote = (src >= 0) & (_rank_of(src, n) != rank)
    s = torch.sort(torch.where(remote, src, NO_SUB)).values
    first = (s != NO_SUB) & torch.cat(
        [torch.ones(1, dtype=torch.bool, device=dev), s[1:] != s[:-1]])
    uidx = torch.cumsum(first.to(torch.int32), 0) - 1
    # slot subs_cap collects the dropped writes (jax's mode="drop")
    subs = torch.full((subs_cap + 1,), NO_SUB, dtype=torch.int32, device=dev)
    keep = first & (uidx < subs_cap)
    subs[torch.where(keep, uidx, subs_cap)] = torch.where(keep, s, NO_SUB)
    subs = subs[:subs_cap]
    n_unique = torch.sum(first.to(torch.int32))
    overflow = torch.clamp_min(n_unique - subs_cap, 0).to(torch.float32)
    slot = torch.clamp(torch.searchsorted(subs, in_edges), 0,
                       subs_cap - 1).to(torch.int32)
    found = subs[slot.to(torch.int64)] == in_edges
    rem2 = (in_edges >= 0) & (_rank_of(in_edges, n) != rank)
    return subs, torch.where(rem2 & found, slot, -1), overflow


def reconstruct_spikes(seed: int, gstep, all_rates, in_edges, rank, n: int,
                       rate_slots=None):
    """Bernoulli(rate) per REMOTE edge (False on local/empty edges); rates
    from the dense (R, n) table, or with ``rate_slots`` from the sparse
    exchange's compact buffer."""
    return reconstruct_remote_spikes(seed, gstep, all_rates, in_edges, rank,
                                     n, rate_slots=rate_slots)


def local_spikes(spiked_last, in_edges, rank, n: int):
    """True spikes for same-rank edges."""
    return local_spike_hits(spiked_last, in_edges, rank, n)
