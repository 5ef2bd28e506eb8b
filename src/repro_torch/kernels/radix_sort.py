"""K3: the Morton sort that feeds the octree build (``tree_impl="fused"``).

The plain versions are the JAX package's ``kernels/radix_sort.py`` ranks on
torch tensors: ``bucket_ranks`` (stable rank within a bucket), ``stable_ranks``
(stable global rank of a bucket sort) and ``radix_ranks`` (stable LSD radix
rank, 8-bit digits), all integer-exact. ``morton_sort_plain`` is the pair the
reference tree build computes: ``rel = clamp(morton_encode(pos, leaf_level) -
leaf_base, 0, n_leaf - 1)`` and ``slot = #{j < i : rel[j] == rel[i]}``.

``morton_sort`` is the wrapper of the hand-written CUDA kernel
``csrc/morton_sort.cu``: on a CUDA tensor it launches the kernel or raises; on
a CPU tensor it runs ``morton_sort_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.core import morton
from repro_torch.kernels import _build

DIGIT_BITS = 8
TILE = 256          # elements per block of the CUDA kernel (csrc/morton_sort.cu)

launches = _build.LaunchCounter("morton_sort")


def bucket_ranks(keys, num_buckets: int):
    """Stable rank of each element within its bucket, #{j < i : keys[j] ==
    keys[i]}, by one masked cumsum per bucket. ``keys`` lie in
    [0, num_buckets)."""
    within = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    for b in range(num_buckets):
        eq = keys == b
        within = torch.where(eq, torch.cumsum(eq.to(torch.int32), 0) - 1,
                             within).to(torch.int32)
    return within


def _histogram(keys, num_buckets: int):
    hist = torch.zeros(num_buckets, dtype=torch.int32, device=keys.device)
    return hist.index_add_(0, keys.to(torch.int64),
                           torch.ones_like(keys, dtype=torch.int32))


def stable_ranks(keys, num_buckets: int):
    """Stable global rank under an ascending bucket sort: #{j : keys[j] <
    keys[i]} + #{j < i : keys[j] == keys[i]}."""
    hist = _histogram(keys, num_buckets)
    start = torch.cumsum(hist, 0) - hist
    return (start[keys.to(torch.int64)] + bucket_ranks(keys, num_buckets)).to(
        torch.int32)


def radix_ranks(keys, key_bits: int):
    """Stable ascending sort rank of each element of ``keys`` (non-negative,
    < 2**key_bits): one ``stable_ranks`` pass per 8-bit digit, permuting
    (key, original index) pairs between passes."""
    n = keys.shape[0]
    k = keys.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    for shift in range(0, max(key_bits, 1), DIGIT_BITS):
        digit = (k >> shift) & ((1 << DIGIT_BITS) - 1)
        r = stable_ranks(digit, 1 << DIGIT_BITS).to(torch.int64)
        k = torch.zeros_like(k).index_put_((r,), k)
        idx = torch.zeros_like(idx).index_put_((r,), idx)
    out = torch.zeros_like(idx)
    out[idx.to(torch.int64)] = torch.arange(n, dtype=torch.int32,
                                            device=keys.device)
    return out


def morton_sort_plain(positions, leaf_base: int, *, leaf_level: int,
                      n_leaf: int):
    """(rel, slot): the leaf cell relative to ``leaf_base``, clamped to
    [0, n_leaf), and the stable rank within the cell — the radix rank
    minus the cell's first rank, as the TPU kernel computes it."""
    rel = morton.morton_encode(positions, leaf_level) - int(leaf_base)
    rel = torch.clamp(rel, 0, n_leaf - 1).to(torch.int32)
    key_bits = max((n_leaf - 1).bit_length(), 1)
    rank = radix_ranks(rel, key_bits)
    hist = _histogram(rel, n_leaf)
    first = torch.cumsum(hist, 0) - hist
    return rel, (rank - first[rel.to(torch.int64)]).to(torch.int32)


def morton_sort(positions, leaf_base: int, *, leaf_level: int, n_leaf: int):
    """Morton-encode (n, 3) positions at ``leaf_level``, rebase to the
    rank's block and rank each neuron within its leaf cell (K3). Returns
    ``(rel, slot)``, both (n,) int32."""
    if positions.device.type != "cuda":
        return morton_sort_plain(positions, leaf_base, leaf_level=leaf_level,
                                 n_leaf=n_leaf)
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError("morton_sort: positions must be (n, 3)")
    if not 0 <= leaf_level <= 10:
        raise ValueError(f"morton_sort: leaf level {leaf_level} outside "
                         f"[0, 10]")
    n = positions.shape[0]
    dev = positions.device
    pos = positions.to(torch.float32).contiguous()
    tiles = max(-(-n // TILE), 1)
    rel = torch.empty(n, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    # (n_leaf, tiles) per-tile cell counts, scanned in place into offsets
    hist = torch.zeros((n_leaf, tiles), dtype=torch.int32, device=dev)
    _build.require_cuda("morton_sort", pos, rel, slot, hist)
    lib = _build.library()
    _build.check(lib.repro_morton_sort(
        pos.data_ptr(), rel.data_ptr(), slot.data_ptr(), hist.data_ptr(), n,
        tiles, int(leaf_base), leaf_level, n_leaf, _build.stream()),
        "morton_sort")
    launches.add()
    return rel, slot
