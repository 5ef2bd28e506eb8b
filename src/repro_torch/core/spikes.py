"""Spike transmission, NEW algorithm (paper §IV-B): every Delta steps ranks
exchange per-neuron rates; between exchanges each receiver draws
Bernoulli(rate) per remote edge from the counter hash keyed by
``(seed, step, edge)``. Local edges always see true spikes.

The dense exchange all-gathers every rank's rates into the replicated
(R, n) table through the rank's ``dist.Comm`` (the identity at R=1). The old
per-step ID exchange and the sparse subscription registry come with
ROADMAP.md Queue 1 item 9.
"""
from __future__ import annotations

from torch.profiler import record_function

from repro_torch.kernels.activity_fused import (local_spike_hits,
                                                reconstruct_remote_spikes)


def exchange_rates(rate, comm):
    """NEW algorithm, send side (every Delta steps): all-gather every rank's
    (n,) rates into the (R, n) table, rows in rank order."""
    with record_function("repro.comm.rates"):
        return comm.all_gather(rate[None])


def reconstruct_spikes(seed: int, gstep, all_rates, in_edges, rank, n: int):
    """Bernoulli(rate) per REMOTE edge (False on local/empty edges)."""
    return reconstruct_remote_spikes(seed, gstep, all_rates, in_edges, rank,
                                     n)


def local_spikes(spiked_last, in_edges, rank, n: int):
    """True spikes for same-rank edges."""
    return local_spike_hits(spiked_last, in_edges, rank, n)
