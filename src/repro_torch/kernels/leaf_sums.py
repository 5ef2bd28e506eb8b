"""The octree build's assembly on the card: the wrapper of
``csrc/leaf_sums.cu``.

Not a TPU kernel: the JAX package assembles the local tree in jnp
(``repro/connectome/tree.py:68-89``: the leaf sums, the parent levels and
the capped membership table). Plain version: ``connectome/tree.py::
assemble_plain``, which reads the fullest leaf's width on the host, adds a
dense (leaf, slot) table column by column, sums the parents with ``_sum8``
and scatters the table; the kernel builds each leaf's member list from
``(rel, slot)`` and adds it in the same ascending neuron order, and the
parents in the same order, so the two are bit-equal. On CUDA tensors
``assemble`` launches the kernel (one cooperative launch) or raises; on CPU
tensors it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.connectome import tree as ctree
from repro_torch.kernels import _build

launches = _build.LaunchCounter("tree_assembly")


def device_launches(*, reset: bool = False) -> int:
    """The assembly's device launches since the last reset, as counted in
    ``csrc/leaf_sums.cu`` beside the launch (one a call); ``reset`` sets the
    count to 0 after reading it."""
    return int(_build.library().repro_tree_assemble_device_launches(
        int(reset)))


def _outputs(n: int, n_leaf: int, levels: int, m: int, dev):
    """One allocation for the levels, the table and the kernel's scratch
    (2 n_leaf + n words). Returns (the kernel's four output and scratch
    pointers, counts and centroid levels, the (n_leaf, m) table), the views
    made by as few tensor calls as there are kinds of output."""
    sizes = [n_leaf >> 3 * (levels - k) for k in range(levels + 1)]
    cells = sum(sizes)
    buf = torch.empty(4 * cells + n_leaf * m + 2 * n_leaf + n,
                      dtype=torch.float32, device=dev)
    c, x, members, _ = buf.split_with_sizes(
        [cells, 3 * cells, n_leaf * m, 2 * n_leaf + n])
    at = buf.data_ptr()
    ptrs = (at, at + 4 * cells, at + 16 * cells,
            at + 16 * cells + 4 * n_leaf * m)
    return (ptrs, c.split_with_sizes(sizes),
            x.view(cells, 3).split_with_sizes(sizes),
            members.view(torch.int32).view(n_leaf, m))


def _launch(pos, w, rel, slot, ptrs, n_leaf: int, levels: int, m: int,
            stream: int) -> None:
    """The C entry on the pointers of ``_outputs``."""
    _build.check(_build.library().repro_tree_assemble(
        pos.data_ptr(), w.data_ptr(), rel.data_ptr(), slot.data_ptr(), *ptrs,
        w.shape[0], n_leaf, levels, m, stream), "assemble")


def assemble(positions, weights, rel, slot, n_leaf: int, local_levels: int,
             members_cap: int):
    """The rank's local tree from neurons in leaf ``rel`` (n,) at the stable
    within-leaf rank ``slot`` (n,): per leaf the sums of ``weights`` (n,)
    and of ``positions * weights[:, None]`` (n, 3) in ascending neuron
    order, ``local_levels`` parent levels above it (each parent its eight
    children added in order), and the membership table. Returns (counts,
    centroids, leaf_members): ``local_levels + 1`` levels each, level 0
    first, (cells,) and (cells, 3) f32, and (n_leaf, members_cap) int32,
    the ``members_cap`` lowest-indexed members of each leaf, -1 padded."""
    if not weights.is_cuda:
        return ctree.assemble_plain(positions, weights, rel, slot, n_leaf,
                                    local_levels, members_cap)
    n = weights.shape[0]
    if positions.shape != (n, 3) or rel.shape != (n,) or slot.shape != (n,):
        raise ValueError("assemble: positions (n, 3), weights, rel and slot "
                         "(n,)")
    if n_leaf < 1 or local_levels < 0 or n_leaf % 8 ** local_levels or \
            members_cap < 0:
        raise ValueError(f"assemble: {n_leaf} leaves, {local_levels} levels "
                         f"above them, {members_cap} members a leaf")
    if not (positions.is_cuda and rel.is_cuda and slot.is_cuda):
        raise ValueError("assemble: every operand must be on the card")
    cast = _build.as_dtype
    pos = cast(positions, torch.float32)
    w = cast(weights, torch.float32)
    r = cast(rel, torch.int32)
    s = cast(slot, torch.int32)
    dev = weights.device
    ptrs, counts, cents, members = _outputs(n, n_leaf, local_levels,
                                            members_cap, dev)
    _launch(pos, w, r, s, ptrs, n_leaf, local_levels, members_cap,
            _build.stream(dev.index))
    launches.add()
    return counts, cents, members
