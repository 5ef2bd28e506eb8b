"""The port's main path against the JAX Simulator: three chunks of
SMOKE_CONFIG with both fused fields (on the CPU the port's fused wrappers run
their plain versions) against the reference's jnp lowerings, which the JAX
package's own tests hold bit-identical to its fused ones.

Tolerance: counters equal up to the first chunk touched by a near-tie (the
activity floats differ from XLA:CPU by a few ulp per step, and a spike flag
may flip where v grazes the threshold, after which the two runs are different
but equally valid trajectories); the test reports that chunk. Inside the port
the fused and reference lowerings agree bitwise."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import SMOKE_CONFIG as J_SMOKE
from repro.sim.api import Simulator as JSim
from repro_torch.configs.msp_brain import SMOKE_CONFIG as T_SMOKE
from repro_torch.kernels import _build
from repro_torch.sim.api import Simulator as TSim

CHUNKS = 3
SLICE = dataclasses.replace(T_SMOKE, activity_impl="fused",
                            connectivity_impl="fused")


def _jax_counters(sim):
    return {k: float(np.asarray(v).sum())
            for k, v in jax.device_get(sim.state.stats.counters).items()}


def test_three_chunks_against_jax_simulator():
    jsim = JSim.from_config(J_SMOKE)
    tsim = TSim.from_config(SLICE, device="cpu")
    first_divergence = None
    for c in range(CHUNKS):
        jsim.step()
        tsim.step()
        want = _jax_counters(jsim)
        got = tsim.stats()
        js = jax.device_get(jsim.state)
        same_flags = np.array_equal(np.asarray(js.neurons.spike_count),
                                    tsim.state.neurons.spike_count.numpy())
        diff = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
        if diff or not same_flags:
            first_divergence = c
            print(f"first near-tie divergence in chunk {c}: {diff}")
            break
        np.testing.assert_array_equal(np.asarray(js.in_edges),
                                      tsim.state.in_edges.numpy())
        np.testing.assert_array_equal(np.asarray(js.out_edges),
                                      tsim.state.out_edges.numpy())
        np.testing.assert_array_equal(np.asarray(js.neurons.rate),
                                      tsim.state.neurons.rate.numpy())
    print(f"counters equal for {CHUNKS if first_divergence is None else first_divergence} "
          f"of {CHUNKS} chunks")
    # a divergence is only acceptable after the first chunk has matched
    assert first_divergence is None or first_divergence >= 1
    h = tsim.health()
    assert h["health_flags"] == 0.0
    assert tsim.stats()["synapses_formed"] > 0


def test_fused_equals_reference_inside_the_port():
    res = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(T_SMOKE, activity_impl=impl,
                                  connectivity_impl=impl)
        sim = TSim.from_config(cfg, device="cpu")
        sim.run(2)
        res[impl] = sim
    a, b = res["reference"].state, res["fused"].state
    for f in a.neurons._fields:
        assert torch.equal(getattr(a.neurons, f), getattr(b.neurons, f)), f
    assert torch.equal(a.in_edges, b.in_edges)
    assert torch.equal(a.out_edges, b.out_edges)
    sa, sb = res["reference"].stats(), res["fused"].stats()
    assert {k: v for k, v in sa.items() if not k.startswith("launches/")} == \
        {k: v for k, v in sb.items() if not k.startswith("launches/")}


def test_run_equals_sequential_steps_and_records_the_chunk_ring():
    a = TSim.from_config(SLICE, device="cpu")
    b = TSim.from_config(SLICE, device="cpu")
    a.run(2)
    b.step()
    b.step()
    assert torch.equal(a.state.in_edges, b.state.in_edges)
    assert a.state.chunk == 2
    ring = a.state.stats.per_chunk["activity_steps"][0]
    assert float(ring[0]) == float(ring[1]) == SLICE.rate_period


def test_cpu_run_launches_no_kernel():
    before = _build.launch_counts()
    sim = TSim.from_config(SLICE, device="cpu")
    sim.step()
    assert _build.launch_counts() == before
    assert all(k in sim.stats() for k in ("launches/activity_window",
                                          "launches/bh_traverse"))


@pytest.mark.parametrize("field,value", [
    ("connectivity_alg", "old"), ("spike_alg", "old"),
    ("rate_exchange", "sparse")])
def test_unported_lowerings_name_their_roadmap_item(field, value):
    """The three lowerings refused until the paper's comparisons were ported
    (ROADMAP.md Queue 1 item 9) now resolve to the port's own code and run
    one chunk equal to the JAX Simulator's: edge tables, spike counts and
    every counter."""
    from repro_torch.sim import registry
    domain = {v: k for k, v in registry.CONFIG_FIELDS.items()}[field]
    assert registry.resolve(domain, value).__module__.startswith(
        "repro_torch.")
    jsim = JSim.from_config(dataclasses.replace(J_SMOKE, **{field: value}))
    tsim = TSim.from_config(dataclasses.replace(T_SMOKE, **{field: value}),
                            device="cpu")
    js = jax.device_get(jsim.step())
    st = tsim.step()
    np.testing.assert_array_equal(np.asarray(js.in_edges),
                                  st.in_edges.numpy())
    np.testing.assert_array_equal(np.asarray(js.out_edges),
                                  st.out_edges.numpy())
    np.testing.assert_array_equal(np.asarray(js.neurons.spike_count),
                                  st.neurons.spike_count.numpy())
    assert _jax_counters(jsim) == {k: v for k, v in tsim.stats().items()
                                   if not k.startswith("launches/")}


@pytest.mark.parametrize("field,impl", [
    ("tree_impl", "build_local_tree_fused"), ("apply_impl", "ApplyImpl")])
def test_tree_and_apply_lowerings_are_ported(field, impl):
    """The fused tree build and apply resolve to the port's own lowerings,
    and a chunk with them equals the reference chunk bitwise."""
    from repro_torch.sim import registry
    domain = field.split("_")[0]
    fused = registry.resolve(domain, "fused")
    assert (type(fused).__name__ if domain == "apply"
            else fused.__name__) == impl
    assert (fused.deletion if domain == "apply" else fused).__module__ \
        .startswith("repro_torch.")
    out = {}
    for value in ("reference", "fused"):
        sim = TSim.from_config(dataclasses.replace(T_SMOKE, **{field: value}),
                               device="cpu")
        sim.run(2)
        out[value] = sim.state
    assert torch.equal(out["reference"].in_edges, out["fused"].in_edges)
    assert torch.equal(out["reference"].out_edges, out["fused"].out_edges)


def test_multi_rank_is_not_ported_yet():
    """The call that was refused before multi-rank was ported,
    ``from_config(SMOKE_CONFIG, num_ranks=4)``, now runs four ranks in this
    process: two chunks healthy, synapses formed, fused == reference
    bitwise (tests/test_torch_multirank.py holds R=4 against JAX)."""
    res = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(T_SMOKE, activity_impl=impl,
                                  connectivity_impl=impl)
        sim = TSim.from_config(cfg, num_ranks=4, device="cpu")
        sim.run(2)
        assert sim.health()["health_flags"] == 0.0
        assert len(sim.rank_states) == 4
        res[impl] = sim
    a, b = res["reference"].state, res["fused"].state
    assert a.in_edges.shape == (4 * T_SMOKE.neurons_per_rank,
                                T_SMOKE.max_synapses)
    assert torch.equal(a.in_edges, b.in_edges)
    assert torch.equal(a.out_edges, b.out_edges)
    assert torch.equal(a.neurons.v, b.neurons.v)
    assert res["fused"].stats()["synapses_formed"] > 0


def test_simulator_runs_a_scenario_with_a_recorder():
    from repro_torch.scenarios import library, observables
    from repro_torch.scenarios.protocol import Lesion
    scn = dataclasses.replace(library.lesion_rewiring(),
                              events=(Lesion("core", t=100),))
    sim = TSim.from_config(library.SMOKE_SCENARIO_CONFIG, scenario=scn,
                           device="cpu")
    st, rec = sim.run(2, recorder=observables.init_recorder(2, 2,
                                                             device="cpu"))
    assert st is sim.state and rec.idx == 2
    hist = observables.flush(rec)
    # the lesion at step 100 lands at the update closing chunk 0
    assert hist["alive"][0, 0] == 0 and hist["synapses"][0, 0] == 0
    from repro_torch.scenarios.regions import region_mask
    core = region_mask(st.positions, scn.regions[0])
    assert bool(core.any())
    assert not bool(st.neurons.ax_elements[core].any())
    assert not bool(st.neurons.rate[core].any())
