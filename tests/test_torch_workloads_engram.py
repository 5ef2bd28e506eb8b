"""The engram workload (``repro_torch.workloads.engram``) in the port against
the JAX package's, at ``SMOKE_CONFIG`` with ``requests_cap_factor=1000`` and
``EngramSpec(2, 1, 1)`` as ``tests/test_workloads.py`` runs it.

Tolerances: ``recall_metrics`` of one state is exactly JAX's. Over the
four-chunk run the neuron counts of the regions and the edge tables are
equal, while the final rates of a few neurons differ: the stimulated
neurons' v drifts from the few-ulp difference of the Box-Muller noise
(XLA:CPU against torch; ROADMAP Queue 3), and a rate sits on a 0.01 grid
against the 0.02 threshold (measured: 3 of 64 neurons after chunk 4, all
three target neurons). So at most one neuron more than measured may
differ, and the recall overlap and the background activation may differ
by the share of their sets' neurons whose final rate differs, and by one
neuron's share where none of the set's neurons differs. Inside the port the run is bitwise the same
across the dense and sparse exchanges and the reference and fused
lowerings (on the CPU: the plain versions).
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.msp_brain import SMOKE_CONFIG as JSMOKE
from repro.workloads import engram as jeng
from repro_torch import convert
from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.workloads import datasets as twds
from repro_torch.workloads import engram as teng

CFG = dataclasses.replace(SMOKE_CONFIG, requests_cap_factor=1000)
JCFG = dataclasses.replace(JSMOKE, requests_cap_factor=1000)
N = CFG.neurons_per_rank
SPEC = dict(train_chunks=2, rest_chunks=1, recall_chunks=1)
DIFFER_MAX = 3 + 1      # neurons whose final rate may differ: measured + 1


def _port(**cfg_kw):
    return teng.run_engram(dataclasses.replace(CFG, **cfg_kw),
                           spec=teng.EngramSpec(**SPEC), device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    return jeng.run_engram(JCFG, spec=jeng.EngramSpec(**SPEC))


def test_recall_metrics_of_one_state_are_jax_s(jax_run):
    """JAX's final state through the port's ``recall_metrics``: the same
    four numbers, exactly."""
    import jax
    want, jsim = jax_run
    st = convert.state_from_numpy(jax.device_get(jsim.state), device="cpu")
    assert teng.recall_metrics(st, teng.EngramSpec(**SPEC)) == want


def test_engram_against_jax(jax_run):
    """The four-chunk protocol: target and cue counts and the edge tables
    equal; each fraction within the share of its set's neurons whose final
    rate differs, or one neuron's share where none differs (printed, with
    whether the metrics were exactly equal)."""
    want, jsim = jax_run
    got, tsim = _port(activity_impl="fused", connectivity_impl="fused",
                      tree_impl="fused", apply_impl="fused")
    assert got["target_neurons"] == want["target_neurons"] > 0
    assert got["cue_neurons"] == want["cue_neurons"] > 0
    np.testing.assert_array_equal(tsim.state.out_edges.numpy(),
                                  np.asarray(jsim.state.out_edges))
    spec = teng.EngramSpec(**SPEC)
    pos = tsim.state.positions
    pat = teng.region_mask(pos, spec.pattern).numpy()
    cue = teng.region_mask(pos, spec.cue).numpy()
    target, outside = pat & ~cue, ~pat
    differs = tsim.state.neurons.rate.numpy() != np.asarray(
        jsim.state.neurons.rate)
    print("metrics exactly equal:", got == want, "; neurons whose final "
          "rate differs:", int(differs.sum()), "of", N)
    assert differs.sum() <= DIFFER_MAX
    for key, region in (("recall_overlap", target),
                        ("background_activation", outside)):
        share = max((differs & region).sum(), 1) / region.sum()
        assert abs(got[key] - want[key]) <= share + 1e-7, key


def test_engram_is_bitwise_the_same_across_layouts_and_lowerings():
    ref = _port()[0]
    for kw in ({"rate_exchange": "sparse"},
               {"activity_impl": "fused"},
               {"rate_exchange": "sparse", "activity_impl": "fused",
                "connectivity_impl": "fused", "tree_impl": "fused",
                "apply_impl": "fused"}):
        assert _port(**kw)[0] == ref, kw
    assert 0.0 <= ref["recall_overlap"] <= 1.0
    assert ref["target_neurons"] > 0 and ref["cue_neurons"] > 0


def test_engram_from_connectome_runs():
    """From a loaded surrogate the run completes, and its health gauges are
    JAX's: the reference itself sets the conservation bit (the loaded edges
    were never counted as formed) and, here, the asymmetry bit (live
    out-entries one or more below the in-entries) on a loaded connectome."""
    ds = twds.generate_hemibrain_surrogate(
        N, N, max_degree=CFG.max_synapses,
        fraction_excitatory=CFG.fraction_excitatory)
    m, sim = teng.run_engram(CFG, spec=teng.EngramSpec(**SPEC), dataset=ds,
                             device="cpu")
    assert 0.0 <= m["recall_overlap"] <= 1.0
    assert sim.stats()["synapses_formed"] >= 0.0
    assert sim.state.chunk == teng.EngramSpec(**SPEC).total_chunks
    _, jsim = jeng.run_engram(JCFG, spec=jeng.EngramSpec(**SPEC), dataset=ds)
    want = jsim.health()
    got = sim.health()
    assert got == want, (got, want)
    assert got["nonfinite_state"] == 0.0
