"""K3's plain version (repro_torch.kernels.radix_sort) against the JAX
package's Pallas ``morton_sort`` in interpret mode, and the fused tree build
against the JAX fused build, from the same numpy inputs.

Tolerance: none. Every quantity is an integer (Morton cells, stable ranks)
or a float sum taken in the same neuron order on both sides, so outputs are
bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.connectome import tree as jtree
from repro.core import morton as jmorton
from repro.kernels import ops as kops
from repro.kernels import radix_sort as jrs
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.connectome import tree as ttree
from repro_torch.kernels import radix_sort as trs
from repro_torch.sim import registry


def _t(x):
    return torch.from_numpy(np.array(x))


def _positions(kind, n, rng, level=3):
    """Random, clustered (many neurons in few leaf cells), on-border
    positions (exact multiples of the leaf cell width, and 1 - 1e-6) and a
    crowd of every neuron in one cell."""
    if kind == "one_cell":
        return np.full((n, 3), 0.3, np.float32)
    if kind == "random":
        pos = rng.random((n, 3))
    elif kind == "clustered":
        centers = rng.random((3, 3))
        pos = centers[rng.integers(0, 3, n)] + rng.normal(0, 1e-3, (n, 3))
    else:
        g = 1 << level
        pos = rng.integers(0, g + 1, (n, 3)) / g
        pos[rng.random((n, 3)) < 0.2] = 1.0 - 1e-6
    return np.clip(pos, 0.0, 1.0 - 1e-6).astype(np.float32)


@pytest.mark.parametrize("buckets", [2, 7, 256])
def test_bucket_and_stable_ranks(buckets):
    rng = np.random.default_rng(buckets)
    keys = rng.integers(0, buckets, 300).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jrs.bucket_ranks(jnp.asarray(keys), buckets)),
        trs.bucket_ranks(_t(keys), buckets).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrs.stable_ranks(jnp.asarray(keys), buckets)),
        trs.stable_ranks(_t(keys), buckets).numpy())


def test_radix_ranks_is_the_stable_argsort_rank():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 12, 500).astype(np.int32)
    keys[:50] = keys[50:100]                      # many equal keys
    want = np.asarray(jrs.radix_ranks(jnp.asarray(keys), 12))
    got = trs.radix_ranks(_t(keys), 12).numpy()
    np.testing.assert_array_equal(want, got)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[order], np.arange(keys.size))


@pytest.mark.parametrize("kind", ["random", "clustered", "border",
                                  "one_cell"])
@pytest.mark.parametrize("num_ranks,rank", [(1, 0), (4, 2)])
def test_morton_sort_equals_pallas_interpret(kind, num_ranks, rank):
    """(rel, slot) of the port's plain version == the JAX kernel's, with
    out-of-block positions clamped (R=4: most neurons lie in other ranks'
    blocks), and with every neuron in one cell (slot = 0, 1, ..., n - 1)."""
    rng = np.random.default_rng(["random", "clustered", "border",
                                 "one_cell"].index(kind) + 10 * rank)
    pos = _positions(kind, 257, rng)
    b = jmorton.branch_level(num_ranks)
    c_per = jmorton.cells_per_rank(num_ranks)
    leaf_level, n_leaf = b + 3, c_per * 8 ** 3
    base = rank * c_per * 8 ** 3
    want_rel, want_slot = kops.morton_sort(
        jnp.asarray(pos), base, leaf_level=leaf_level, n_leaf=n_leaf,
        interpret=True)
    before = trs.launches.count
    rel, slot = trs.morton_sort(_t(pos), base, leaf_level=leaf_level,
                                n_leaf=n_leaf)
    assert trs.launches.count == before           # CPU: the plain version
    np.testing.assert_array_equal(np.asarray(want_rel), rel.numpy())
    np.testing.assert_array_equal(np.asarray(want_slot), slot.numpy())
    assert rel.dtype == slot.dtype == torch.int32
    # and the reference build's pair: stable within-cell rank
    np.testing.assert_array_equal(
        slot.numpy(), ttree.positions_within(rel, n_leaf).numpy())
    if kind == "one_cell":
        np.testing.assert_array_equal(slot.numpy(), np.arange(pos.shape[0]))


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_fused_tree_build_equals_jax_fused_build(kind):
    rng = np.random.default_rng(11)
    n = 96
    jcfg = JConfig(neurons_per_rank=n, local_levels=3, frontier_cap=32,
                   max_synapses=8, tree_impl="fused")
    tcfg = TConfig(neurons_per_rank=n, local_levels=3, frontier_cap=32,
                   max_synapses=8, tree_impl="fused")
    pos = _positions(kind, n, rng)
    w = (rng.random(n) * 2).astype(np.float32)
    want = jtree.build_tree(jcfg, jnp.asarray(pos), jnp.asarray(w), 0, 1)
    got = ttree.build_tree(tcfg, _t(pos), _t(w), 0, 1)
    assert registry.resolve("tree", "fused") is ttree.build_local_tree_fused
    for a, b in zip(jax.tree_util.tree_leaves(want)[:-1],
                    list(got.counts) + list(got.centroids)
                    + [got.leaf_members]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = ttree.build_tree(dataclasses.replace(tcfg, tree_impl="reference"),
                           _t(pos), _t(w), 0, 1)
    for a, b in zip(ref.counts + ref.centroids, got.counts + got.centroids):
        assert torch.equal(a, b)
    assert torch.equal(ref.leaf_members, got.leaf_members)
