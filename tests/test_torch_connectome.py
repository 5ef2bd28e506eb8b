"""The port's synapse-table and octree stages against the JAX package, each
from injected JAX inputs: retraction, deletion routing, message removal +
compaction, stable bucket ranks, acceptance, out-edge writes, tree build.

Tolerances: integer tables equal; tree counts and centroids within 1e-6
relative (they come out equal: both sum each leaf in neuron order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.connectome import routing as jrouting
from repro.connectome import synapses as jsyn
from repro.connectome import tree as jtree
from repro_torch import dist, prng
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.connectome import routing as trouting
from repro_torch.connectome import synapses as tsyn
from repro_torch.connectome import tree as ttree



def _t(x):
    return torch.from_numpy(np.array(x))


def _edge_table(rng, n, s, gid_hi, fill=0.6):
    e = rng.integers(0, gid_hi, (n, s)).astype(np.int32)
    e[rng.random((n, s)) > fill] = -1
    return e


def _keys(seed):
    return (jax.random.fold_in(jax.random.key(seed), 3),
            prng.fold_in(prng.key(seed), 3))


# ---------------------------------------------------------------- synapses
@pytest.mark.parametrize("seed", [0, 1])
def test_retract_synapses(seed):
    rng = np.random.default_rng(seed)
    n, s = 64, 8
    edges = _edge_table(rng, n, s, 4 * n)
    n_del = rng.integers(0, 4, n).astype(np.int32)
    gids = np.arange(n, dtype=np.int32) + 64
    kj, kt = _keys(seed)
    we, wk = jax.jit(jsyn.retract_synapses)(kj, jnp.asarray(edges),
                                            jnp.asarray(n_del),
                                            jnp.asarray(gids))
    ge, gk = tsyn.retract_synapses(kt, _t(edges), _t(n_del), _t(gids))
    np.testing.assert_array_equal(np.asarray(we), ge.numpy())
    np.testing.assert_array_equal(np.asarray(wk), gk.numpy())
    assert gk.sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_route_deletions_single_rank(seed):
    rng = np.random.default_rng(seed)
    n, s = 64, 8
    edges = _edge_table(rng, n, s, n)
    kill = (rng.random((n, s)) < 0.3) & (edges >= 0)
    gids = np.arange(n, dtype=np.int32)[:, None]
    for cfg_n in (64, 40):   # cap n//4 = 16 < kills: the drop count runs too
        jcfg = JConfig(neurons_per_rank=n, max_synapses=s)
        tcfg = TConfig(neurons_per_rank=n, max_synapses=s)
        if cfg_n != n:
            jcfg = dataclasses.replace(jcfg, neurons_per_rank=cfg_n)
            tcfg = dataclasses.replace(tcfg, neurons_per_rank=cfg_n)
        wm, wd = jrouting.route_deletions(
            jnp.asarray(kill), jnp.asarray(edges), jnp.asarray(gids), jcfg,
            None, 1, False)
        gm, gd = trouting.route_deletions(_t(kill), _t(edges), _t(gids),
                                          tcfg, dist.SINGLE, False)
        np.testing.assert_array_equal(np.asarray(wm), gm.numpy())
        assert float(wd) == float(gd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remove_messages_and_compact(seed):
    rng = np.random.default_rng(seed)
    n, s, q = 48, 8, 60
    edges = _edge_table(rng, n, s, 10)        # few values: repeated partners
    lid = rng.integers(0, n, q).astype(np.int32)
    gid = rng.integers(0, 10, q).astype(np.int32)
    valid = rng.random(q) < 0.8
    want = jax.jit(jsyn._deletion_reference)(
        jnp.asarray(edges), jnp.asarray(lid), jnp.asarray(gid),
        jnp.asarray(valid))
    got = tsyn._deletion_reference(_t(edges), _t(lid), _t(gid), _t(valid))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(np.asarray(jsyn.compact(jnp.asarray(edges))),
                                  tsyn.compact(_t(edges)).numpy())


@pytest.mark.parametrize("buckets", [3, 17])
def test_positions_within(buckets):
    ids = np.random.default_rng(buckets).integers(0, buckets, 500).astype(
        np.int32)
    np.testing.assert_array_equal(
        np.asarray(jtree.positions_within(jnp.asarray(ids), buckets)),
        ttree.positions_within(_t(ids), buckets).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_accept_requests_and_add_out_edges(seed):
    rng = np.random.default_rng(seed)
    n, s, q = 40, 6, 120
    in_edges = jsyn.compact(jnp.asarray(_edge_table(rng, n, s, 4 * n, 0.4)))
    in_np = np.asarray(in_edges)
    tgt = rng.integers(0, n, q).astype(np.int32)
    src = rng.integers(0, 4 * n, q).astype(np.int32)
    valid = rng.random(q) < 0.85
    vac = (rng.random(n) * 4).astype(np.float32)
    kj, kt = _keys(seed + 10)
    wa, wn = jax.jit(jsyn.accept_requests)(
        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(valid),
        jnp.asarray(vac), in_edges, kj)
    ga, gn = tsyn.accept_requests(_t(tgt), _t(src), _t(valid), _t(vac),
                                  _t(in_np), kt)
    np.testing.assert_array_equal(np.asarray(wa), ga.numpy())
    np.testing.assert_array_equal(np.asarray(wn), gn.numpy())
    assert ga.sum() > 0
    out = _edge_table(rng, n, s, 4 * n, 0.5)
    out = np.asarray(jsyn.compact(jnp.asarray(out)))
    tg = rng.integers(0, 4 * n, n).astype(np.int32)
    acc = rng.random(n) < 0.5
    np.testing.assert_array_equal(
        np.asarray(jsyn.add_out_edges(jnp.asarray(out), jnp.asarray(tg),
                                      jnp.asarray(acc))),
        tsyn.add_out_edges(_t(out), _t(tg), _t(acc)).numpy())


# ---------------------------------------------------------------- tree
def _tree_inputs(n=300, local_levels=3, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * 0.999).astype(np.float32)
    vac = (rng.random(n) * 2).astype(np.float32)
    vac[rng.random(n) < 0.2] = 0.0
    jcfg = JConfig(neurons_per_rank=n, local_levels=local_levels,
                   frontier_cap=32, max_synapses=8)
    tcfg = TConfig(neurons_per_rank=n, local_levels=local_levels,
                   frontier_cap=32, max_synapses=8)
    return pos, vac, jcfg, tcfg


@pytest.mark.parametrize("members_cap", [2, 4])
def test_build_local_tree(members_cap):
    pos, vac, jcfg, tcfg = _tree_inputs()
    want = jtree.build_local_tree(jnp.asarray(pos), jnp.asarray(vac), 0,
                                  jcfg, 1, members_cap=members_cap)
    got = ttree.build_local_tree(_t(pos), _t(vac), 0, tcfg, 1,
                                 members_cap=members_cap)
    for a, b in zip(want.counts + want.centroids, got.counts + got.centroids):
        a = np.asarray(a, np.float64)
        rel = np.abs(a - b.numpy()) / np.maximum(np.abs(a), 1.0)
        assert rel.max() <= 1e-6
    np.testing.assert_array_equal(np.asarray(want.leaf_members),
                                  got.leaf_members.numpy())


def test_tree_is_bitwise_reproducible_and_matches_top_tree():
    pos, vac, _, tcfg = _tree_inputs(seed=4)
    a = ttree.build_local_tree(_t(pos), _t(vac), 0, tcfg, 1)
    b = ttree.build_local_tree(_t(pos), _t(vac), 0, tcfg, 1)
    for x, y in zip(a.counts + a.centroids, b.counts + b.centroids):
        assert torch.equal(x, y)
    top = ttree.exchange_branch_nodes(a, dist.SINGLE)
    assert torch.equal(top.counts[0], a.counts[0])
