"""Spike transmission, NEW algorithm (paper §IV-B): every Delta steps ranks
exchange per-neuron rates; between exchanges each receiver draws
Bernoulli(rate) per remote edge from the counter hash keyed by
``(seed, step, edge)``. Local edges always see true spikes.

The slice runs one rank with the dense exchange, where ``exchange_rates`` is
the identity reshaped to the (1, n) table. The old per-step ID exchange and
the sparse subscription registry come with ROADMAP.md Queue 1 item 9, the
collectives with item 8.
"""
from __future__ import annotations

from repro_torch.kernels.activity_fused import (local_spike_hits,
                                                reconstruct_remote_spikes)


def exchange_rates(rate, num_ranks: int):
    """NEW algorithm, send side (every Delta steps): all-exchange rates."""
    if num_ranks != 1:
        raise NotImplementedError(
            "multi-rank rate exchange: ROADMAP.md Queue 1 item 8")
    return rate[None]


def reconstruct_spikes(seed: int, gstep, all_rates, in_edges, rank, n: int):
    """Bernoulli(rate) per REMOTE edge (False on local/empty edges)."""
    return reconstruct_remote_spikes(seed, gstep, all_rates, in_edges, rank,
                                     n)


def local_spikes(spiked_last, in_edges, rank, n: int):
    """True spikes for same-rank edges."""
    return local_spike_hits(spiked_last, in_edges, rank, n)
