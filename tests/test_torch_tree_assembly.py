"""The tree assembly (``kernels/leaf_sums.py::assemble``) on CPU tensors,
which runs its plain version ``connectome/tree.py::assemble_plain``, against
the JAX package's ``connectome/tree.py::_assemble_tree`` from the same
(rel, slot): every level's counts and centroids and the membership table.

Tolerance: none. Both add each leaf in ascending neuron order from +0.0 and
each parent's eight children in order, so the sums are bit-equal; the table
is integers. The weights mix magnitudes (1e-3 to 1e6) and zeros, so an add
in another order would show. The kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import types

import jax
import numpy as np
import pytest
import torch

from repro.connectome import tree as jtree
from repro_torch.connectome import tree as ttree
from repro_torch.kernels import leaf_sums as ls


def _layout(rng, n, n_leaf, layout):
    """Leaf indices (n,) int32 of one layout."""
    if layout == "spread":
        return rng.integers(0, n_leaf, n).astype(np.int32)
    if layout == "one_leaf":           # every row clamped into one leaf
        return np.full(n, n_leaf - 1, np.int32)
    if layout == "clamped_ends":       # rows outside the block, clamped
        rel = rng.integers(0, n_leaf, n)
        out = rng.random(n) < 0.6
        rel[out] = np.where(rng.random(out.sum()) < 0.5, 0, n_leaf - 1)
        return rel.astype(np.int32)
    # "few": a handful of crowded leaves among empty ones
    return rng.choice(np.array([3, 5, n_leaf // 2, n_leaf - 2]),
                      n).astype(np.int32)


def _inputs(seed, n, n_leaf, layout):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    w = (10.0 ** rng.uniform(-3, 6, n)).astype(np.float32)
    w[rng.random(n) < 0.25] = 0.0
    rel = _layout(rng, n, n_leaf, layout)
    slot = np.asarray(jtree.positions_within(rel, n_leaf), np.int32)
    return pos, w, rel, slot


@pytest.mark.parametrize("n", [1, 3, 257, 1000])
@pytest.mark.parametrize("layout", ["spread", "one_leaf", "clamped_ends",
                                    "few"])
@pytest.mark.parametrize("levels,c_per,members_cap", [
    (2, 1, 4), (3, 2, 1), (1, 7, 64)])
def test_plain_assembly_equals_jax(n, layout, levels, c_per, members_cap):
    n_leaf = c_per * 8 ** levels
    pos, w, rel, slot = _inputs(n + levels, n, n_leaf, layout)
    cfg = types.SimpleNamespace(local_levels=levels)
    want = jax.device_get(jtree._assemble_tree(pos, w, rel, slot, cfg,
                                               n_leaf, 0, members_cap))
    before = ls.launches.count
    counts, cents, members = ls.assemble(
        *(torch.from_numpy(a) for a in (pos, w, rel, slot)), n_leaf, levels,
        members_cap)
    assert ls.launches.count == before        # CPU: the plain version
    assert len(counts) == len(cents) == levels + 1
    for k in range(levels + 1):
        assert counts[k].shape == (c_per * 8 ** k,)
        assert cents[k].shape == (c_per * 8 ** k, 3)
        np.testing.assert_array_equal(counts[k].numpy(),
                                      np.asarray(want.counts[k]))
        np.testing.assert_array_equal(cents[k].numpy(),
                                      np.asarray(want.centroids[k]))
    assert members.shape == (n_leaf, members_cap)
    np.testing.assert_array_equal(members.numpy(),
                                  np.asarray(want.leaf_members))


@pytest.mark.parametrize("members_cap", [1, 2, 4])
def test_membership_table_keeps_the_lowest_indexed_members(members_cap):
    """The members_cap overflow: a leaf holding more members than the cap
    lists its members_cap lowest-indexed neurons in ascending order, and a
    leaf holding fewer pads with -1, as the JAX table does."""
    n, n_leaf = 300, 64
    pos, w, rel, slot = _inputs(5, n, n_leaf, "few")
    _, _, members = ls.assemble(
        *(torch.from_numpy(a) for a in (pos, w, rel, slot)), n_leaf, 2,
        members_cap)
    for leaf in range(n_leaf):
        mine = np.flatnonzero(rel == leaf)[:members_cap]
        row = members[leaf].numpy()
        np.testing.assert_array_equal(row[:mine.size], mine)
        assert (row[mine.size:] == -1).all()
    assert (np.bincount(rel, minlength=n_leaf) > members_cap).any()


def test_assemble_tree_is_the_wrapper_on_both_lowerings():
    """``_assemble_tree`` returns the wrapper's levels and table for the
    reference and the fused (rel, slot), which are the same, so the two
    tree lowerings give one tree."""
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    import dataclasses
    rng = np.random.default_rng(2)
    n = SMOKE_CONFIG.neurons_per_rank
    pos = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 3, n).astype(np.float32))
    trees = [ttree.build_tree(dataclasses.replace(SMOKE_CONFIG, tree_impl=i),
                              pos, w, 0, 1) for i in ("reference", "fused")]
    for a, b in zip(trees[0].counts + trees[0].centroids,
                    trees[1].counts + trees[1].centroids):
        assert torch.equal(a, b)
    assert torch.equal(trees[0].leaf_members, trees[1].leaf_members)
    assert len(trees[0].counts) == SMOKE_CONFIG.local_levels + 1
