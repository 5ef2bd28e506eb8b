"""Named spatial regions of the simulation domain.

Regions are axis-aligned boxes in the unit cube — the same [0,1]^3 the
Morton decomposition partitions — so each rank evaluates its own neurons'
membership from their positions. The last bucket (index ``len(regions)``) is
the implicit "rest" region for neurons outside every named box. The port's
copy of the JAX package's ``scenarios/regions.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Region:
    """Axis-aligned box [lo, hi) in the unit cube, with optional per-region
    background-drive overrides (None inherits BrainConfig)."""
    name: str
    lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hi: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    bg_mean: Optional[float] = None
    bg_std: Optional[float] = None


def region_mask(positions, region: Region):
    """(n, 3) positions -> (n,) bool membership."""
    lo = torch.tensor(region.lo, dtype=torch.float32, device=positions.device)
    hi = torch.tensor(region.hi, dtype=torch.float32, device=positions.device)
    return torch.all((positions >= lo) & (positions < hi), dim=-1)


def num_buckets(regions: Sequence[Region]) -> int:
    """Named regions + the trailing 'rest' bucket."""
    return len(regions) + 1


def assign_regions(positions, regions: Sequence[Region]):
    """(n,) int32 region id per neuron; the first matching region wins,
    neurons outside every box land in the 'rest' bucket."""
    rid = torch.full((positions.shape[0],), len(regions), dtype=torch.int32,
                     device=positions.device)
    for i in reversed(range(len(regions))):
        rid = torch.where(region_mask(positions, regions[i]),
                          torch.tensor(i, dtype=torch.int32,
                                       device=positions.device), rid)
    return rid


def background_tables(positions, regions: Sequence[Region], cfg):
    """Per-neuron background drive (mean, std) honoring region overrides;
    the config's scalars when no region overrides anything."""
    if not any(r.bg_mean is not None or r.bg_std is not None
               for r in regions):
        return cfg.background_mean, cfg.background_std
    n, dev = positions.shape[0], positions.device
    mean = torch.full((n,), cfg.background_mean, dtype=torch.float32,
                      device=dev)
    std = torch.full((n,), cfg.background_std, dtype=torch.float32,
                     device=dev)
    for r in regions:
        if r.bg_mean is None and r.bg_std is None:
            continue
        m = region_mask(positions, r)
        if r.bg_mean is not None:
            mean = torch.where(m, torch.tensor(r.bg_mean, dtype=torch.float32,
                                               device=dev), mean)
        if r.bg_std is not None:
            std = torch.where(m, torch.tensor(r.bg_std, dtype=torch.float32,
                                              device=dev), std)
    return mean, std


def _count(index, size: int):
    """Occurrences of each value of ``index`` in [0, size) (int64 adds:
    exact and the same in any order)."""
    return torch.zeros(size, dtype=torch.int64, device=index.device) \
        .index_add_(0, index.reshape(-1).to(torch.int64),
                    torch.ones(index.numel(), dtype=torch.int64,
                               device=index.device))


def region_counts(region_ids, nb: int):
    """(nb,) int32 neuron count per region bucket."""
    return _count(region_ids, nb).to(torch.int32)


def region_connectome(out_edges, src_region_ids, region_of_gid, nb: int):
    """Region x region synapse-count matrix from an out-edge table:
    [src_region, tgt_region] -> #synapses, (nb, nb) float32. Integer counts,
    so exact in any order."""
    valid = out_edges >= 0
    safe = torch.clamp(out_edges, 0, region_of_gid.shape[0] - 1).to(
        torch.int64)
    tgt_r = region_of_gid[safe].to(torch.int64)
    src_r = torch.broadcast_to(src_region_ids[:, None].to(torch.int64),
                               out_edges.shape)
    cell = torch.where(valid, src_r * nb + tgt_r, nb * nb)   # nb*nb: empty
    return _count(cell, nb * nb + 1)[:nb * nb].reshape(nb, nb).to(
        torch.float32)
