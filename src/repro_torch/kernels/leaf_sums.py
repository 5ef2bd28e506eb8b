"""The octree build's leaf sums on the card: the wrapper of
``csrc/leaf_sums.cu``.

Not a TPU kernel: the JAX package sums the leaves in jnp
(``repro/connectome/tree.py:76-78``). Plain version:
``connectome/tree.py::_leaf_sums``, which reads the fullest leaf's width on
the host and adds a dense (leaf, slot) table column by column; the kernel
builds each leaf's member list from ``(rel, slot)`` and adds it in the same
ascending neuron order, so the two are bit-equal. On CUDA tensors
``leaf_sums`` launches the kernel or raises; on CPU tensors it runs the
plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.connectome import tree as ctree
from repro_torch.kernels import _build

launches = _build.LaunchCounter("leaf_sums")


@functools.lru_cache(maxsize=64)
def _workspace(n: int, n_leaf: int) -> int:
    return int(_build.library().repro_leaf_sums_workspace(n, n_leaf))


def leaf_sums(positions, weights, rel, slot, n_leaf: int):
    """Per-leaf sums of ``weights`` (n,) and ``positions * weights[:, None]``
    (n, 3), each in ascending neuron order, for neurons in leaf ``rel``
    (n,) at the stable within-leaf rank ``slot`` (n,). Returns
    ``(counts (n_leaf,), centroids (n_leaf, 3))``, both f32."""
    if weights.device.type != "cuda":
        return (ctree._leaf_sums(weights, rel, slot, n_leaf),
                ctree._leaf_sums(positions * weights[:, None], rel, slot,
                                 n_leaf))
    n = weights.shape[0]
    if positions.shape != (n, 3) or rel.shape != (n,) or slot.shape != (n,):
        raise ValueError("leaf_sums: positions (n, 3), weights, rel and slot "
                         "(n,)")
    if n_leaf < 1:
        raise ValueError(f"leaf_sums: {n_leaf} leaves")
    dev = weights.device
    pos = positions.to(torch.float32).contiguous()
    w = weights.to(torch.float32).contiguous()
    r = rel.to(torch.int32).contiguous()
    s = slot.to(torch.int32).contiguous()
    counts = torch.empty(n_leaf, dtype=torch.float32, device=dev)
    cents = torch.empty((n_leaf, 3), dtype=torch.float32, device=dev)
    _build.require_cuda("leaf_sums", pos, w, r, s, counts, cents)
    stream = _build.stream(dev.index)
    words = _workspace(n, n_leaf)
    work = _build.scratch(dev, stream, words)
    _build.check(_build.library().repro_leaf_sums(
        pos.data_ptr(), w.data_ptr(), r.data_ptr(), s.data_ptr(),
        counts.data_ptr(), cents.data_ptr(), work.data_ptr(), n, n_leaf,
        stream), "leaf_sums")
    launches.add()
    return counts, cents
