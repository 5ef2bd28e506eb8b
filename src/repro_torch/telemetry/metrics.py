"""Device-side metrics: counters, the per-chunk ring, histograms and gauges.

The same tree as the JAX package's ``telemetry/metrics.py`` (key names,
bucket counts, health bits), held as small float32 tensors on the state's
device with the leading per-rank axis of size 1. The JAX ``Metrics`` is an
immutable pytree; here the recording methods update the tensors in place and
return ``self``, so call sites read the same (``stats = stats.count(...)``).

Every rank records its own tree; the reductions over ranks happen at read
time (``reduce_counters``, ``reduce_gauges``), and ``join`` / ``split`` go
between the per-rank trees and the global one, whose leading axis holds the
ranks in order (the JAX package's global arrays).

Histogram updates are scatter-adds of 0/1 weights into small integer counts:
exact in float32 in any order, so the atomics of ``index_add_`` on CUDA leave
them deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

LEGACY_KEYS = ("spikes_sent", "rates_sent", "subscription_requests",
               "subscription_overflow", "bh_requests", "bh_responses",
               "formation_requests", "synapses_formed", "synapses_deleted",
               "tree_nodes_downloaded", "request_overflow")
EXTRA_KEYS = ("activity_steps", "activity_spikes", "tree_nodes_built",
              "bh_restarts")
COUNTER_KEYS = LEGACY_KEYS + EXTRA_KEYS

HIST_BUCKETS = {
    "spikes_per_step": 16,   # fraction of neurons firing per step, [0, 1)
    "subs_occupancy": 16,    # filled fraction of the subscription registry
    "frontier_depth": 8,     # Barnes-Hut restarts per phase-B query
}

GAUGE_KEYS = ("health_flags", "nonfinite_state", "out_edges_live",
              "in_edges_live")

HEALTH_NONFINITE = 1     # NaN/Inf anywhere in the physical state
HEALTH_ASYMMETRY = 2     # sum(out_live) != sum(in_live) w/o overflow
HEALTH_CONSERVATION = 4  # live entries outside the [2F-2D, 2F-D] bound

DEFAULT_HISTORY = 64


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass
class Metrics:
    """``counters`` {name: (1,)}, ``per_chunk`` {name: (1, H)}, ``hists``
    {name: (1, B)}, ``gauges`` {name: (1,)}; all float32 tensors."""
    counters: Dict[str, torch.Tensor]
    per_chunk: Dict[str, torch.Tensor]
    hists: Dict[str, torch.Tensor]
    gauges: Dict[str, torch.Tensor]

    def __getitem__(self, key):
        return self.counters[key]

    def __contains__(self, key):
        return key in self.counters

    def keys(self):
        return self.counters.keys()

    def items(self):
        return self.counters.items()

    # -------------------------------------------------- recording (in place)
    def count(self, name: str, delta) -> "Metrics":
        """Add ``delta`` (scalar, any numeric dtype) to counter ``name``."""
        c = self.counters[name]
        c += _f32(delta, c.device)
        return self

    def observe(self, name: str, bucket, weight=None) -> "Metrics":
        """Add ``weight`` (default 1.0 each) into histogram ``name`` at
        ``bucket`` (any-shape integer tensor, pre-clipped by the caller)."""
        h = self.hists[name]
        b = bucket.reshape(-1).to(torch.int64)
        w = torch.ones(b.shape, dtype=torch.float32, device=h.device) \
            if weight is None else weight.reshape(-1).to(torch.float32)
        h[0].index_add_(0, b, w)
        return self

    def record_chunk(self, start_counters: Dict[str, torch.Tensor],
                     chunk: int) -> "Metrics":
        """Write this chunk's counter increments into ring slot
        ``chunk % H``."""
        for k, ring in self.per_chunk.items():
            slot = int(chunk) % ring.shape[1]
            ring[0, slot] = self.counters[k][0] - start_counters[k][0]
        return self

    def set_gauges(self, updates: Dict[str, torch.Tensor]) -> "Metrics":
        for k, v in updates.items():
            g = self.gauges[k]
            g.copy_(torch.reshape(_f32(v, g.device), (1,)))
        return self


_PARTS = ("counters", "per_chunk", "hists", "gauges")


def join(per_rank) -> Metrics:
    """The ranks' trees as one, each leaf's leading axis the ranks in
    order."""
    return Metrics(*({k: torch.cat([getattr(m, part)[k] for m in per_rank])
                      for k in getattr(per_rank[0], part)}
                     for part in _PARTS))


def split(m: Metrics, num_ranks: int) -> list:
    """A global tree -> one tree a rank (leading axes of size 1)."""
    return [Metrics(*({k: v[r:r + 1].clone()
                       for k, v in getattr(m, part).items()}
                      for part in _PARTS)) for r in range(num_ranks)]


def reduce_counters(per_rank) -> Dict[str, float]:
    """Every counter summed over ranks."""
    return {k: float(torch.cat([m.counters[k] for m in per_rank]).sum())
            for k in per_rank[0].counters}


def reduce_gauges(per_rank) -> Dict[str, float]:
    """The gauges over ranks: ``health_flags`` (the same on every rank) by
    max, the census gauges summed."""
    out = {}
    for k in per_rank[0].gauges:
        v = torch.cat([m.gauges[k] for m in per_rank])
        out[k] = float(v.max() if k == "health_flags" else v.sum())
    return out


def init_metrics(history: int = DEFAULT_HISTORY, device=None) -> Metrics:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return Metrics(
        counters={k: z(1) for k in COUNTER_KEYS},
        per_chunk={k: z(1, history) for k in COUNTER_KEYS},
        hists={k: z(1, b) for k, b in HIST_BUCKETS.items()},
        gauges={k: z(1) for k in GAUGE_KEYS})


@dataclasses.dataclass(frozen=True)
class Recorder:
    """Recording math shared by every phase implementation (one expression
    per quantity, whichever lowering produced its inputs). ``n`` is
    neurons-per-rank (the spikes-per-step normalizer)."""
    n: int

    def activity_window(self, m: Metrics, spikes_per_step) -> Metrics:
        """Record one rate window from its (T,) per-step fired counts."""
        t = spikes_per_step.shape[0]
        m = m.count("activity_steps", float(t))
        m = m.count("activity_spikes", torch.sum(spikes_per_step))
        nb = HIST_BUCKETS["spikes_per_step"]
        frac = spikes_per_step / float(self.n)
        bucket = torch.clamp((frac * nb).to(torch.int32), 0, nb - 1)
        return m.observe("spikes_per_step", bucket)

    def tree_built(self, m: Metrics, local_tree) -> Metrics:
        """Count the non-empty octree nodes of this chunk's local tree."""
        built = sum(torch.sum((c > 0).to(torch.float32))
                    for c in local_tree.counts)
        return m.count("tree_nodes_built", built)

    def traversal(self, m: Metrics, depth, mask) -> Metrics:
        """Record phase-B restart depths for the queries in ``mask``."""
        w = mask.to(torch.float32)
        m = m.count("bh_restarts", torch.sum(depth.to(torch.float32) * w))
        nb = HIST_BUCKETS["frontier_depth"]
        bucket = torch.clamp(depth, 0, nb - 1)
        return m.observe("frontier_depth", bucket, w)

    def subs_occupancy(self, m: Metrics, subs, no_sub) -> Metrics:
        """One histogram entry per chunk: the filled fraction of the sparse
        exchange's subscription registry."""
        cap = torch.full((), float(subs.shape[0]), dtype=torch.float32,
                         device=subs.device)
        frac = torch.sum((subs != no_sub).to(torch.float32)) / cap
        nb = HIST_BUCKETS["subs_occupancy"]
        bucket = torch.clamp((frac * nb).to(torch.int32), 0, nb - 1)
        return m.observe("subs_occupancy", bucket[None])
