"""Device-side scenario recorder: a per-chunk ring buffer (the port's copy of
the JAX package's ``scenarios/observables.py``).

``record`` works on the state's tensors and leaves them on their device until
``flush``. Per chunk it stores, per region bucket (named regions + 'rest'):
mean calcium, mean advertised rate, synapse counts by source region, alive
neurons, the region x region connectome, and a global rate histogram.

Every float sum is taken in a fixed order — one masked ``torch.sum`` per
bucket for the means; the counts are integer adds — so a run repeated from
one seed records bitwise-equal rows on the card (``index_add_`` of floats
would add with CUDA atomics in a changing order). Against the JAX package,
whose scatter-add sums in neuron order, the means agree within the f32 sum
order.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.scenarios import regions as regions_mod

RATE_HIST_MAX = 0.5   # rates are spikes/ms; 0.5 == 500 Hz ceiling
FIELDS = ("calcium", "rate", "synapses", "alive", "connectome", "rate_hist")


class Recorder(NamedTuple):
    idx: int                  # total chunks recorded
    calcium: torch.Tensor     # (cap, nb) mean calcium per region
    rate: torch.Tensor        # (cap, nb) mean rate per region
    synapses: torch.Tensor    # (cap, nb) out-synapses per source region
    alive: torch.Tensor       # (cap, nb) neurons alive per region
    connectome: torch.Tensor  # (cap, nb, nb) region x region synapse counts
    rate_hist: torch.Tensor   # (cap, bins) global rate histogram


def init_recorder(cap: int, nb: int, bins: int = 16,
                  device=None) -> Recorder:
    """An empty ring of ``cap`` chunks over ``nb`` region buckets, on the
    card unless ``device`` names another (``device.resolve_device``)."""
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return Recorder(0, z(cap, nb), z(cap, nb), z(cap, nb), z(cap, nb),
                    z(cap, nb, nb), z(cap, bins))


def _segment_mean(values, rid, nb: int):
    sums = torch.stack([torch.sum(torch.where(rid == b, values, 0.0))
                        for b in range(nb)])
    counts = regions_mod.region_counts(rid, nb).to(torch.float32)
    return sums / torch.clamp_min(counts, 1.0)


def _with_row(ring, slot: int, row):
    out = ring.clone()
    out[slot] = row
    return out


def record(rec: Recorder, positions, calcium, rate, out_edges,
           regions: Sequence, alive=None) -> Recorder:
    """Append one chunk of observables; returns the advanced recorder (the
    given one is left as it was). ``alive`` is an optional (n,) bool mask."""
    nb = regions_mod.num_buckets(regions)
    rid = regions_mod.assign_regions(positions, regions)
    cap = rec.calcium.shape[0]
    slot = rec.idx % cap
    alive_rid = rid if alive is None else torch.where(alive, rid, nb)
    n_alive = regions_mod.region_counts(alive_rid, nb + 1)[:nb]
    conn = regions_mod.region_connectome(out_edges, rid, rid, nb)
    bins = rec.rate_hist.shape[1]
    bin_of = torch.clamp((rate / RATE_HIST_MAX * bins).to(torch.int32), 0,
                         bins - 1)
    hist = regions_mod.region_counts(bin_of, bins).to(torch.float32)
    return Recorder(
        idx=rec.idx + 1,
        calcium=_with_row(rec.calcium, slot,
                          _segment_mean(calcium, rid, nb)),
        rate=_with_row(rec.rate, slot, _segment_mean(rate, rid, nb)),
        synapses=_with_row(rec.synapses, slot, torch.sum(conn, dim=1)),
        alive=_with_row(rec.alive, slot, n_alive.to(torch.float32)),
        connectome=_with_row(rec.connectome, slot, conn),
        rate_hist=_with_row(rec.rate_hist, slot, hist))


def flush(rec: Recorder) -> dict:
    """Move the ring to the host, oldest chunk first: numpy arrays of
    leading length min(idx, cap), plus ``num_recorded``."""
    idx = int(rec.idx)
    cap = rec.calcium.shape[0]
    kept = min(idx, cap)
    order = (np.arange(idx - kept, idx) % cap) if kept else np.arange(0)
    out = {"num_recorded": idx}
    for name in FIELDS:
        out[name] = getattr(rec, name).detach().cpu().numpy()[order]
    return out
