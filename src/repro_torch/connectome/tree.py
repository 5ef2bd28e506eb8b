"""Level-array spatial octree (the paper's pointer octree as dense levels).

A node at octree level L covering Morton cell c has children 8c..8c+7 at
level L+1, so the tree is a family of dense per-level arrays (vacant-element
counts + weighted centroid sums) and bottom-up aggregation sums groups of 8
siblings, which Morton order keeps contiguous.

Float sums are taken in a fixed order on every device: a leaf's count and
centroid are the sum of its neurons in ascending neuron index (the order of
the reference's sequential scatter-add), and a parent's the sum of its 8
children in order. ``index_add_`` on CUDA would add with atomics in an order
that changes from run to run; here the local tree comes from the assembly
kernel on the card (``kernels/leaf_sums.py``, one launch: each leaf's
members listed in ascending order and added in that order, the parents
added in order, the membership table) and, on the CPU, from
``assemble_plain`` (a dense (leaf, within-leaf slot) table summed column by
column), so a chunk run twice from one seed gives bitwise-equal trees and
edge tables.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core import morton
from repro_torch.kernels import radix_sort
from repro_torch.sim import registry


class LocalTree(NamedTuple):
    """Per-rank subtree. levels[k] covers octree level (b + k): (cells,)
    counts and (cells, 3) centroid sums. leaf_members: (n_leaf, M) local
    neuron indices (-1 pad)."""
    counts: tuple
    centroids: tuple
    leaf_members: torch.Tensor
    base_cell: int


class TopTree(NamedTuple):
    """Replicated upper tree: levels 0..b (level k has 8^k cells)."""
    counts: tuple
    centroids: tuple


def positions_within(ids, num_buckets: int):
    """Rank of each element within its bucket (stable: equal ids keep their
    original order, so ranks count earlier occurrences)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order].contiguous()
    buckets = torch.arange(num_buckets, dtype=sorted_ids.dtype,
                           device=ids.device)
    first = torch.searchsorted(sorted_ids, buckets, side="left")
    ranks = torch.arange(n, dtype=torch.int64, device=ids.device) \
        - first[sorted_ids.to(torch.int64)]
    out = torch.empty(n, dtype=torch.int32, device=ids.device)
    out[order] = ranks.to(torch.int32)
    return out


def _tree_geometry(rank: int, cfg, num_ranks: int):
    """(leaf_level, n_leaf, base_cell) of the rank's subdomain block."""
    b = morton.branch_level(num_ranks)
    c_per = morton.cells_per_rank(num_ranks)
    lloc = cfg.local_levels
    return b + lloc, c_per * 8 ** lloc, rank * c_per


def _sum8(x):
    """Sum groups of 8 consecutive rows, children in order."""
    g = x.reshape(-1, 8, *x.shape[1:])
    acc = g[:, 0]
    for j in range(1, 8):
        acc = acc + g[:, j]
    return acc


_PLAIN_CUDA = [0]


def plain_cuda_calls(reset: bool = False) -> int:
    """Calls of the plain ``_leaf_sums`` on CUDA tensors since the last
    reset; ``reset`` sets the count to 0 after reading it."""
    k = _PLAIN_CUDA[0]
    if reset:
        _PLAIN_CUDA[0] = 0
    return k


def _leaf_sums(values, rel, slot, n_leaf: int):
    """Per-leaf sums of ``values`` ((n,) or (n, 3)) in ascending neuron
    order: scatter each neuron into its (leaf, slot) cell of a dense table,
    then add the slot columns in order. The plain version of the assembly
    kernel's leaf sums: it reads the width on the host and allocates
    n_leaf x width."""
    if values.device.type == "cuda":
        _PLAIN_CUDA[0] += 1
    width = int(slot.max().item()) + 1 if slot.numel() else 1
    tbl = torch.zeros((n_leaf, width) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    tbl[rel.to(torch.int64), slot.to(torch.int64)] = values
    acc = torch.zeros((n_leaf,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    for j in range(width):
        acc = acc + tbl[:, j]
    return acc


def assemble_plain(positions, weights, rel, slot, n_leaf: int,
                   local_levels: int, members_cap: int):
    """Leaf sums, parent aggregation, and the capped membership table: the
    plain version of the assembly kernel (``kernels/leaf_sums.py``).
    Returns (counts, centroids, leaf_members), levels 0 first."""
    counts = [_leaf_sums(weights, rel, slot, n_leaf)]
    centroids = [_leaf_sums(positions * weights[:, None], rel, slot, n_leaf)]
    for _ in range(local_levels):
        counts.insert(0, _sum8(counts[0]))
        centroids.insert(0, _sum8(centroids[0]))

    # leaf membership table (cap M per leaf; overflow dropped this round)
    m = members_cap
    ok = slot < m
    tbl = torch.full((n_leaf, m + 1), -1, dtype=torch.int32,
                     device=positions.device)
    tbl[rel.to(torch.int64), torch.where(ok, slot, m).to(torch.int64)] = \
        torch.arange(positions.shape[0], dtype=torch.int32,
                     device=positions.device)
    return tuple(counts), tuple(centroids), tbl[:, :m].contiguous()


def _assemble_tree(positions, weights, rel, slot, cfg, n_leaf: int,
                   base_cell: int, members_cap: int) -> LocalTree:
    """The local tree from (rel, slot): the assembly kernel on the card,
    ``assemble_plain`` on the CPU."""
    from repro_torch.kernels import leaf_sums   # lazy: it imports us
    counts, centroids, members = leaf_sums.assemble(
        positions, weights, rel, slot, n_leaf, cfg.local_levels, members_cap)
    return LocalTree(counts, centroids, members, base_cell)


@registry.register_phase("tree", "reference")
def build_local_tree(positions, weights, rank: int, cfg, num_ranks: int,
                     members_cap: int = 4) -> LocalTree:
    """positions: (n,3); weights: (n,) vacant dendritic elements (>=0).
    Returns the rank's subtree. A leaf holding more than ``members_cap``
    neurons keeps the lowest-indexed ones in its membership table."""
    leaf_level, n_leaf, base_cell = _tree_geometry(rank, cfg, num_ranks)
    leaf_cells_abs = morton.morton_encode(positions, leaf_level)
    rel = leaf_cells_abs - base_cell * 8 ** cfg.local_levels
    rel = torch.clamp(rel, 0, n_leaf - 1)
    slot = positions_within(rel, n_leaf)
    return _assemble_tree(positions, weights, rel, slot, cfg, n_leaf,
                          base_cell, members_cap)


@registry.register_phase("tree", "fused")
def build_local_tree_fused(positions, weights, rank: int, cfg,
                           num_ranks: int, members_cap: int = 4) -> LocalTree:
    """The same build with (rel, slot) from the Morton-sort kernel K3
    (``kernels/radix_sort.py``): one pass for encode, rebase and the stable
    within-leaf ranks."""
    leaf_level, n_leaf, base_cell = _tree_geometry(rank, cfg, num_ranks)
    rel, slot = radix_sort.morton_sort(
        positions, base_cell * 8 ** cfg.local_levels, leaf_level=leaf_level,
        n_leaf=n_leaf)
    return _assemble_tree(positions, weights, rel, slot, cfg, n_leaf,
                          base_cell, members_cap)


def build_tree(cfg, positions, weights, rank: int, num_ranks: int,
               members_cap: int = 4) -> LocalTree:
    """Registry dispatch on ``cfg.tree_impl``."""
    build = registry.resolve("tree", cfg.tree_impl)
    return build(positions, weights, rank, cfg, num_ranks, members_cap)


def build_top_tree(branch_counts, branch_centroids, num_ranks: int) -> TopTree:
    """branch_*: (8^b,) / (8^b, 3) — the all-exchanged branch nodes."""
    b = morton.branch_level(num_ranks)
    counts = [branch_counts]
    cents = [branch_centroids]
    for _ in range(b):
        counts.insert(0, _sum8(counts[0]))
        cents.insert(0, _sum8(cents[0]))
    return TopTree(tuple(counts), tuple(cents))


def exchange_branch_nodes(local: LocalTree, comm) -> TopTree:
    """Alg. 1 line 3: all_exchange_branch_nodes. Every rank's level-0
    (branch) counts and centroids are all-gathered in rank order, which is
    Morton order (the identity at R=1)."""
    with record_function("repro.comm.branch_nodes"):
        bc = comm.all_gather(local.counts[0])
        bz = comm.all_gather(local.centroids[0])
    return build_top_tree(bc, bz, comm.num_ranks)
