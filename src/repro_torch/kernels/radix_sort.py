"""K3: the Morton sort that feeds the octree build (``tree_impl="fused"``),
and K6: the stable LSD radix argsort of the public kernel API.

The plain versions are the JAX package's ``kernels/radix_sort.py`` ranks on
torch tensors: ``bucket_ranks`` (stable rank within a bucket), ``stable_ranks``
(stable global rank of a bucket sort) and ``radix_ranks`` (stable LSD radix
rank, 8-bit digits), all integer-exact. ``morton_sort_plain`` is the pair the
reference tree build computes: ``rel = clamp(morton_encode(pos, leaf_level) -
leaf_base, 0, n_leaf - 1)`` and ``slot = #{j < i : rel[j] == rel[i]}``.

``radix_argsort_plain`` is the JAX package's ``radix_argsort``: the sorted
keys and the order, one stable 8-bit digit pass per byte of ``key_bits``
(at least one), so only the low 8 * ceil(key_bits / 8) bits of a key count
and a negative key sorts by its two's-complement bytes.

``morton_sort`` and ``radix_argsort`` are the wrappers of the hand-written
CUDA kernels ``csrc/morton_sort.cu`` (one cooperative launch a call) and
``csrc/radix_argsort.cu`` (a onesweep sort: one digit-count launch, then one
launch a pass with decoupled look-back): on a CUDA tensor they launch the
kernel or raise; on a CPU tensor they run the plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import morton
from repro_torch.kernels import _build

DIGIT_BITS = 8
MORTON_MAX_CELLS = 1 << 22  # n_leaf: the cell field of csrc/morton_sort.cu's keys
MORTON_TOO_LARGE = -3       # its C entry: a block's neurons exceed shared memory
ARGSORT_TILE = 4096  # keys per onesweep tile of csrc/radix_argsort.cu
ARGSORT_HIST_BLOCKS = 128  # at most, for its digit-count launch
ARGSORT_MAX_KEYS = 1 << 30  # prefixes are 30-bit counts

launches = _build.LaunchCounter("morton_sort")
argsort_launches = _build.LaunchCounter("radix_argsort")


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


@functools.lru_cache(maxsize=64)
def _morton_workspace(device_index: int, n: int, n_leaf: int) -> int:
    """int32 words of scratch a call takes on the device (its grid x its
    histogram window, twice when n_leaf spans several windows)."""
    del device_index    # a key only: the C entry reads the current device
    return int(_build.library().repro_morton_sort_workspace(n, n_leaf))


def morton_device_launches(*, reset: bool = False) -> int:
    """Kernel launches ``morton_sort`` has made on the card, counted in
    ``csrc/morton_sort.cu`` beside the launch (one a call); ``reset`` sets
    the count to 0 after reading it."""
    return int(_build.library().repro_morton_sort_device_launches(
        int(reset)))


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
    if not 1 <= n_leaf <= MORTON_MAX_CELLS:
        raise ValueError(f"morton_sort: {n_leaf} leaf cells outside [1, "
                         f"{MORTON_MAX_CELLS}], what the kernel's keys hold")
    n = positions.shape[0]
    dev = positions.device
    pos = positions.to(torch.float32).contiguous()
    rel = torch.empty(n, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return rel, slot
    words = _morton_workspace(dev.index, n, n_leaf)
    stream = _build.stream(dev.index)
    work = _build.scratch(dev, stream, words)
    _build.require_cuda("morton_sort", pos, rel, slot)
    rc = _build.library().repro_morton_sort(
        pos.data_ptr(), rel.data_ptr(), slot.data_ptr(), work.data_ptr(),
        words, n, int(leaf_base), leaf_level, n_leaf, stream)
    if rc == MORTON_TOO_LARGE:
        raise ValueError(f"morton_sort: {n} neurons are more than the "
                         f"kernel's blocks hold in shared memory beside "
                         f"their histograms")
    _build.check(rc, "morton_sort")
    launches.add()
    return rel, slot


def _passes(key_bits: int) -> int:
    return len(range(0, max(key_bits, 1), DIGIT_BITS))


def radix_argsort_plain(keys, *, key_bits: int = 30):
    """(sorted_keys, order), both (n,) int32: ``order`` is the stable
    ascending argsort of the keys' low 8 * ceil(key_bits / 8) bits, read as
    unsigned bytes; ``sorted_keys`` the keys in that order."""
    k = keys.to(torch.int32)
    rank = radix_ranks(k, key_bits).to(torch.int64)
    n = k.shape[0]
    order = torch.zeros(n, dtype=torch.int32, device=k.device)
    order[rank] = torch.arange(n, dtype=torch.int32, device=k.device)
    return torch.zeros_like(k).index_put_((rank,), k), order


@functools.lru_cache(maxsize=64)
def _argsort_workspace(n: int, passes: int) -> int:
    """int32 words of scratch a call takes (laid out by the C entry)."""
    return int(_build.library().repro_radix_argsort_workspace(n, passes))


def device_launches(*, reset: bool = False) -> int:
    """Kernel launches ``radix_argsort`` has made on the card, counted in
    ``csrc/radix_argsort.cu`` beside each launch (one digit count, then one
    onesweep launch a pass); ``reset`` sets the count to 0 after reading."""
    return int(_build.library().repro_radix_argsort_device_launches(
        int(reset)))


def radix_argsort(keys, *, key_bits: int = 30):
    """Stable LSD radix argsort of (n,) int32 keys (K6). Returns
    ``(sorted_keys, order)``, both (n,) int32."""
    if keys.device.type != "cuda":
        return radix_argsort_plain(keys, key_bits=key_bits)
    if keys.dim() != 1:
        raise ValueError("radix_argsort: keys must be (n,)")
    if keys.dtype.is_floating_point:
        raise TypeError(f"radix_argsort: integer keys only, got {keys.dtype}")
    if key_bits > 32:
        raise ValueError(f"radix_argsort: key_bits {key_bits} above 32")
    n = keys.shape[0]
    if n >= ARGSORT_MAX_KEYS:
        raise ValueError(f"radix_argsort: {n} keys; the look-back's 30-bit "
                         f"prefixes take fewer than 2**30")
    k = keys if keys.dtype == torch.int32 and keys.is_contiguous() else \
        keys.to(torch.int32).contiguous()
    passes = _passes(key_bits)
    words = _argsort_workspace(n, passes) if n else 0
    out_k = torch.empty(n, dtype=torch.int32, device=k.device)
    out_i = torch.empty(n, dtype=torch.int32, device=k.device)
    work = torch.empty(max(words, 1), dtype=torch.int32, device=k.device)
    _build.require_cuda("radix_argsort", k, out_k, out_i)
    _build.check(_build.library().repro_radix_argsort(
        k.data_ptr(), out_k.data_ptr(), out_i.data_ptr(), work.data_ptr(),
        words, n, passes, _build.stream()), "radix_argsort")
    argsort_launches.add()
    return out_k, out_i
