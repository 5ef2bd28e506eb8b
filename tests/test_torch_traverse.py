"""The port's Barnes-Hut search and the whole connectivity update against
the JAX package, from injected JAX inputs: phase A over a top tree, phase B
(the Pallas traversal kernel in interpret mode against the port's K2 wrapper
on the CPU), and one whole update.

Tolerance: integer tables equal; phase-A/B picks equal except counted
near-ties (none seen at these sizes; XLA:CPU and torch can differ by a few
ulp in the distance and the Gaussian, which may flip a Gumbel-max pick only
where two candidates tie within that)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.configs.msp_brain import SMOKE_CONFIG as J_SMOKE
from repro.connectome import traverse as jtrav
from repro.connectome import tree as jtree
from repro.core import engine as jengine
from repro.kernels.bh_traverse import bh_traverse as jax_bh_traverse
from repro.sim import phases as jphases
from repro_torch import convert
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.configs.msp_brain import SMOKE_CONFIG as T_SMOKE
from repro_torch.connectome import traverse as ttrav
from repro_torch.connectome import tree as ttree
from repro_torch.connectome.update import connectivity_update
from repro_torch.kernels import bh_traverse as tbh
from repro_torch.sim import phases as tphases

NEAR_TIE_SHARE = 0.01   # at most 1% of picks may differ (near-ties)


def _t(x):
    return torch.from_numpy(np.array(x))


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


# ---------------------------------------------------------------- phase A/B
def test_phase_a_over_a_top_tree():
    """Phase A only searches at R > 1 (branch level 1): run it on the top
    tree 8 ranks would build from these branch nodes."""
    pos, vac, jcfg, tcfg = _tree_inputs(n=400, local_levels=1)
    local_j = jtree.build_local_tree(jnp.asarray(pos), jnp.asarray(vac), 0,
                                     jcfg, 1)
    local_t = ttree.build_local_tree(_t(pos), _t(vac), 0, tcfg, 1)
    top_j = jtree.build_top_tree(local_j.counts[1], local_j.centroids[1], 8)
    top_t = ttree.build_top_tree(local_t.counts[1], local_t.centroids[1], 8)
    gids = np.arange(400, dtype=np.int32)
    wc, wv = jtrav.phase_a(top_j, jnp.asarray(pos), jnp.asarray(gids), jcfg,
                           8, chunk=jnp.int32(3))
    gc, gv = ttrav.phase_a(top_t, _t(pos), _t(gids), tcfg, 8, chunk=3)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    differ = int((np.asarray(wc) != gc.numpy()).sum())
    assert differ <= NEAR_TIE_SHARE * 400
    assert len(np.unique(gc.numpy())) > 1


# one compiled interpret-mode kernel for every case (same shapes, static kw)
_jax_phase_b = jax.jit(functools.partial(
    jax_bh_traverse, seed=3, sizes=tuple(1.0 / (1 << k) for k in range(4)),
    theta=JConfig.theta, sigma=JConfig.sigma, frontier=32, n_levels=4,
    interpret=True))


@pytest.mark.parametrize("chunk", [0, 5])
def test_phase_b_kernel_against_pallas_interpret(chunk):
    pos, vac, jcfg, tcfg = _tree_inputs(n=256, local_levels=3, seed=chunk)
    q = 200
    rng = np.random.default_rng(chunk + 1)
    x = (rng.random((q, 3)) * 0.999).astype(np.float32)
    gids = rng.permutation(256)[:q].astype(np.int32)
    valid = rng.random(q) < 0.9
    start = np.zeros(q, np.int32)
    tree_j = jtree.build_local_tree(jnp.asarray(pos), jnp.asarray(vac), 0,
                                    jcfg, 1)
    tree_t = ttree.build_local_tree(_t(pos), _t(vac), 0, tcfg, 1)
    sj = jtrav.stack_levels(tree_j.counts, tree_j.centroids, 0)
    st = ttrav.stack_levels(tree_t.counts, tree_t.centroids, 0)
    kw = dict(seed=3, sizes=sj.sizes, theta=jcfg.theta, sigma=jcfg.sigma,
              frontier=jcfg.frontier_cap, n_levels=jcfg.local_levels + 1)
    want = _jax_phase_b(sj.counts, sj.centroids, tree_j.leaf_members,
                        jnp.asarray(pos), jnp.asarray(vac), jnp.asarray(x),
                        jnp.asarray(start), jnp.asarray(gids),
                        jnp.asarray(valid), jnp.int32(chunk), jnp.int32(0))
    before = tbh.launches.count
    got = tbh.bh_traverse(st.counts, st.centroids, tree_t.leaf_members,
                          _t(pos), _t(vac), _t(x), _t(start), _t(gids),
                          _t(valid), chunk, 0, **kw)
    assert tbh.launches.count == before      # CPU tensors: plain version
    differ = int((np.asarray(want[0]) != got[0].numpy()).sum())
    print(f"phase B: {differ} of {q} picks differ (near-ties)")
    assert differ <= NEAR_TIE_SHARE * q
    same = np.asarray(want[0]) == got[0].numpy()
    np.testing.assert_array_equal(np.asarray(want[1])[same],
                                  got[1].numpy()[same])
    np.testing.assert_array_equal(np.asarray(want[2])[same],
                                  got[2].numpy()[same])
    assert int(got[1].sum()) > 0
    assert not got[1].numpy()[~valid].any()


# ---------------------------------------------------------------- update
def _jax_connectivity(cfg):
    mesh = jengine.make_brain_mesh()
    shapes = jax.eval_shape(lambda: jengine.init_state(cfg, 0, 1))
    specs = jengine.state_specs(shapes)

    def body(st):
        rank = jax.lax.axis_index("ranks")
        ctx = jphases.make_context(cfg, rank, "ranks", 1)
        return jphases.connectivity_phase(st, ctx)
    return jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(specs,),
                                    out_specs=specs, check_vma=False))


def _jax_state(st):
    """The port's state as the reference's BrainState (numpy leaves)."""
    from repro.core.neuron import NeuronState as JNeuronState
    from repro.telemetry.metrics import Metrics as JMetrics
    d = convert.state_to_numpy(st)
    return jengine.BrainState(
        neurons=JNeuronState(**d["neurons"]), out_edges=d["out_edges"],
        in_edges=d["in_edges"], positions=d["positions"],
        rates_table=d["rates_table"], subs=None, rate_slots=None,
        remote_rates=None, chunk=d["chunk"],
        stats=JMetrics(**d["stats"]))


def test_connectivity_update_from_injected_state():
    """One whole update (retraction with routed notifications, tree, phase
    B through the fused wrapper, acceptance, rate refresh and exchange),
    both sides from one state: grown for two chunks, then a quarter of the
    neurons' elements cut so retraction has work to do."""
    jcfg = dataclasses.replace(J_SMOKE, connectivity_impl="fused")
    tcfg = dataclasses.replace(T_SMOKE, connectivity_impl="fused")
    from repro_torch.sim.api import Simulator as TSim
    sim = TSim.from_config(T_SMOKE, device="cpu")
    sim.run(2)
    st = sim.state
    ax, de = st.neurons.ax_elements.clone(), st.neurons.de_elements.clone()
    ax[::4] = 0.0
    de[1::4] = 0.0
    st = st._replace(neurons=st.neurons._replace(ax_elements=ax,
                                                 de_elements=de))
    want = jax.device_get(_jax_connectivity(jcfg)(
        jax.tree.map(jnp.asarray, _jax_state(st))))
    ctx = tphases.make_context(tcfg, 0, 1, device="cpu")
    got = connectivity_update(st, ctx)
    np.testing.assert_array_equal(np.asarray(want.in_edges),
                                  got.in_edges.numpy())
    np.testing.assert_array_equal(np.asarray(want.out_edges),
                                  got.out_edges.numpy())
    np.testing.assert_array_equal(np.asarray(want.neurons.rate),
                                  got.neurons.rate.numpy())
    np.testing.assert_array_equal(np.asarray(want.rates_table),
                                  got.rates_table.numpy())
    assert got.chunk == int(want.chunk)
    for k, v in want.stats.counters.items():
        assert float(np.asarray(v)[0]) == float(got.stats.counters[k][0]), k
    for k, v in want.stats.hists.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      got.stats.hists[k].numpy(), err_msg=k)
    assert float(got.stats.counters["synapses_deleted"][0]) > 0
