"""The sparse rate exchange (``rate_exchange="sparse"``: a subscription
registry built from the in-edge table, the owners pushing only the
subscribed rates, K1 reading them through the edge -> slot remap) in the
port against the JAX package at R=1 and R=4, and the invariant inside the
port: sparse == dense bitwise while the registry does not overflow.

Tolerances are those of ``_torch_ranks``: the registry (``subs``,
``rate_slots``), the pushed rates, the edge tables and every counter
(``rates_sent``, ``subscription_requests``, ``subscription_overflow``
among them) bit-equal; v, u and calcium within 2e-3 x max(|x|, 1) over
free-running chunks.
"""
import numpy as np
import pytest

import _torch_ranks as tr
from repro.connectome import routing as jrouting
from repro.core import spikes as jspikes
from repro_torch import convert
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.connectome import routing as trouting
from repro_torch.core import engine as tengine
from repro_torch.core import spikes as tspikes

# head-room that never overflows (cap = min(n S, (R-1) n)), and the default
# factor 2 (64 slots at R=4); the registry's overflow is held against JAX on
# dense random tables in test_torch_compare_spikes.py
SPARSE = dict(tr.SMALL, rate_exchange="sparse", subs_cap_factor=1000)
SPARSE_DEFAULT = dict(tr.SMALL, rate_exchange="sparse")
SPARSE_FIELDS = ("out_edges", "in_edges", "subs", "rate_slots",
                 "remote_rates")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX reference of the sparse exchange: three chunks from the seed
    at R=1 and R=4 (also with the default registry at R=4), the vmapped update
    from the state after chunk 2, and the JAX Simulator on four host devices
    in a subprocess (waited for by the test that reads it)."""
    path = str(tmp_path_factory.mktemp("mesh") / "mesh.npz")
    mesh = tr.start_mesh(SPARSE, path)
    runs = {(r, "roomy"): tr.jax_run(SPARSE, r) for r in (1, 4)}
    runs[(4, "default")] = tr.jax_run(SPARSE_DEFAULT, 4)
    updates = {r: tr.jax_update(SPARSE, r, runs[(r, "roomy")][1][2])
               for r in (1, 4)}
    yield {"runs": runs, "updates": updates, "mesh": (mesh, path)}
    tr.stop(mesh)


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_init_state_holds_the_empty_registry(num_ranks):
    """``init_state``'s sparse fields: the registry of ``cap_subs`` NO_SUB
    pads, every slot -1, the pushed rates 0, no dense table; the same
    capacity as the reference's."""
    from repro.configs.msp_brain import BrainConfig as JConfig
    cfg = TConfig(**SPARSE_DEFAULT)
    cap = trouting.cap_subs(cfg, num_ranks)
    assert cap == jrouting.cap_subs(JConfig(**SPARSE_DEFAULT), num_ranks)
    for r in range(num_ranks):
        st = tengine.init_state(cfg, r, num_ranks, device="cpu")
        assert st.rates_table is None
        assert st.subs.tolist() == [tspikes.NO_SUB] * cap
        assert st.rate_slots.shape == (cfg.neurons_per_rank,
                                       cfg.max_synapses)
        assert (st.rate_slots == -1).all() and (st.remote_rates == 0).all()
    assert tspikes.NO_SUB == int(jspikes.NO_SUB)


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("num_ranks", [1, 4])
def test_one_sparse_update_from_an_injected_state(jax_ref, num_ranks, impl):
    """One connectivity update with the sparse exchange from the JAX state
    after chunk 2, split into the ranks by ``convert.states_from_numpy``
    (the sparse fields carried): edge tables, the registry, the slot remap,
    the pushed rates and every counter bit-equal."""
    fields = dict(SPARSE, **{f: impl for f in tr.FUSED})
    before = jax_ref["runs"][(num_ranks, "roomy")][0][2]
    got = tr.port_update(fields, num_ranks, before)
    want = jax_ref["updates"][num_ranks]
    tr.assert_update_equal(got, want, SPARSE_FIELDS)
    assert got["rates_table"] is None
    if num_ranks > 1:
        assert got["stats"]["counters"]["subscription_requests"].sum() > 0
    np.testing.assert_array_equal(got["stats"]["hists"]["subs_occupancy"],
                                  np.asarray(want.stats.hists[
                                      "subs_occupancy"]))


@pytest.mark.parametrize("num_ranks,room", [(1, "roomy"), (4, "roomy"),
                                            (4, "default")])
def test_three_sparse_chunks_from_the_seed_against_jax(jax_ref, num_ranks,
                                                       room):
    """Three chunks of the sparse exchange from the seed: per chunk the edge
    tables, the registry, the pushed rates and every rank's counters equal
    to JAX's, the activity floats within FLOAT_TOL; health 0."""
    fields = SPARSE if room == "roomy" else SPARSE_DEFAULT
    sim, states = tr.port_run(dict(fields, **tr.FUSED), num_ranks)
    tr.assert_chunks_match(states, jax_ref["runs"][(num_ranks, room)][0],
                           SPARSE_FIELDS[2:])
    assert sim.health()["health_flags"] == 0.0


@pytest.mark.parametrize("num_ranks", [1, 2, 4])
def test_sparse_equals_dense_inside_the_port(num_ranks):
    """The paper's invariant, both sides the port's own code: the sparse
    exchange reads exactly the dense table's rates when nothing overflows,
    so from one seed, through the lesion, the edge tables and every neuron
    field are bitwise equal after every chunk; only the exchange's byte
    counters differ (sparse ships at most the dense count)."""
    scn = convert.scenario_from_reference(tr.scaled_lesion())
    runs = {}
    for ex in ("dense", "sparse"):
        runs[ex] = tr.port_run(dict(SPARSE, rate_exchange=ex, **tr.FUSED),
                               num_ranks, chunks=4, scenario=scn)
    for a, b in zip(runs["dense"][1], runs["sparse"][1]):
        for f in ("out_edges", "in_edges"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        for f in a["neurons"]:
            np.testing.assert_array_equal(a["neurons"][f], b["neurons"][f],
                                          err_msg=f)
    dense, sparse = runs["dense"][0].stats(), runs["sparse"][0].stats()
    assert sparse["subscription_overflow"] == 0
    assert sparse["rates_sent"] <= dense["rates_sent"]
    assert (sparse["subscription_requests"] > 0) == (num_ranks > 1)


def test_sparse_state_converts_at_four_ranks(jax_ref):
    """A JAX global sparse state at R=4 (the registry, slots and pushed
    rates as per-rank rows) goes into the port's four rank states and back
    unchanged."""
    want = jax_ref["runs"][(4, "roomy")][0][3]
    states = convert.states_from_numpy(want, 4, device="cpu")
    cap = trouting.cap_subs(TConfig(**SPARSE), 4)
    for st in states:
        assert st.subs.shape == (cap,) and st.remote_rates.shape == (cap,)
        assert st.rates_table is None
    back = convert.states_to_numpy(states)
    for f in ("subs", "rate_slots", "remote_rates", "in_edges"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert back["rates_table"] is None


def test_vmap_reference_equals_the_mesh(jax_ref):
    """The vmap reference of the sparse exchange against the JAX Simulator
    on four host devices: edge tables and every rank's counters equal after
    every chunk."""
    tr.assert_mesh_equals_vmap(*jax_ref["mesh"],
                               jax_ref["runs"][(4, "roomy")][0])
