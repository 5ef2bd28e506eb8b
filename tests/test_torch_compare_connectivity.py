"""The paper's OLD connectivity algorithm (``connectivity_alg="old"``: every
rank downloads all subtrees and leaf data, searches locally and sends plain
formation requests) in the port against the JAX package at R=1 and R=4, and
the paper's invariant inside the port: old == new bitwise.

The JAX reference and the tolerances are those of ``_torch_ranks``: edge
tables and every counter (``tree_nodes_downloaded``, ``formation_requests``
and the other byte counters among them) bit-equal; v, u and calcium within
2e-3 x max(|x|, 1) over free-running chunks.
"""
import numpy as np
import pytest

import _torch_ranks as tr
from repro_torch import convert

OLD = dict(tr.SMALL, connectivity_alg="old")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX reference of the old algorithm: three chunks from the seed at
    R=1 and R=4, the vmapped update from the state after chunk 2 with and
    without the scaled lesion, and the JAX Simulator on four host devices in
    a subprocess (waited for by the test that reads it)."""
    path = str(tmp_path_factory.mktemp("mesh") / "mesh.npz")
    mesh = tr.start_mesh(OLD, path)
    runs = {r: tr.jax_run(OLD, r) for r in (1, 4)}
    updates = {(r, s): tr.jax_update(OLD, r, runs[r][1][2],
                                     None if s is None else tr.scaled_lesion())
               for r in (1, 4) for s in (None, "lesion")}
    yield {"runs": runs, "updates": updates, "mesh": (mesh, path)}
    tr.stop(mesh)


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("scenario", [None, "lesion"])
@pytest.mark.parametrize("num_ranks", [1, 4])
def test_one_old_update_from_an_injected_state(jax_ref, num_ranks, scenario,
                                               impl):
    """One connectivity update of the old algorithm from the JAX state
    after chunk 2: edge tables, the rates table and every counter
    bit-equal; at R=4 the download is counted, at R=1 it is 0."""
    fields = dict(OLD, **{f: impl for f in tr.FUSED})
    before = jax_ref["runs"][num_ranks][0][2]
    got = tr.port_update(fields, num_ranks, before,
                         None if scenario is None else tr.scaled_lesion())
    want = jax_ref["updates"][(num_ranks, scenario)]
    tr.assert_update_equal(got, want, ("out_edges", "in_edges",
                                       "rates_table"))
    downloaded = got["stats"]["counters"]["tree_nodes_downloaded"]
    assert (downloaded > 0).all() if num_ranks > 1 else (downloaded == 0).all()
    assert got["stats"]["counters"]["synapses_formed"].sum() > 0


@pytest.mark.parametrize("num_ranks", [1, 4])
def test_three_old_chunks_from_the_seed_against_jax(jax_ref, num_ranks):
    """Three chunks of the old algorithm from the seed: per chunk the edge
    tables and every rank's counters equal to JAX's, the activity floats
    within FLOAT_TOL; health 0."""
    sim, states = tr.port_run(dict(OLD, **tr.FUSED), num_ranks)
    tr.assert_chunks_match(states, jax_ref["runs"][num_ranks][0],
                           ("rates_table",))
    assert sim.health()["health_flags"] == 0.0
    assert sim.stats()["tree_nodes_downloaded"] == (
        0.0 if num_ranks == 1 else pytest.approx(float(
            np.asarray(jax_ref["runs"][num_ranks][0][-1].stats.counters[
                "tree_nodes_downloaded"]).sum())))


@pytest.mark.parametrize("num_ranks", [1, 2, 4])
def test_old_equals_new_inside_the_port(num_ranks):
    """The paper's invariant, both sides the port's own code: the old and
    the new algorithm form the same synapses from one seed (no request
    overflow at requests_cap_factor 1000), through the lesion: edge tables,
    every neuron field, synapses_formed and synapses_deleted bitwise equal
    after every chunk, on every rank."""
    scn = convert.scenario_from_reference(tr.scaled_lesion())
    runs = {}
    for alg in ("new", "old"):
        sim, states = tr.port_run(dict(tr.SMALL, connectivity_alg=alg,
                                       **tr.FUSED), num_ranks, scenario=scn)
        runs[alg] = (sim, states)
    for a, b in zip(runs["new"][1], runs["old"][1]):
        for f in ("out_edges", "in_edges"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        for f in a["neurons"]:
            np.testing.assert_array_equal(a["neurons"][f], b["neurons"][f],
                                          err_msg=f)
        for k in ("synapses_formed", "synapses_deleted", "request_overflow"):
            np.testing.assert_array_equal(a["stats"]["counters"][k],
                                          b["stats"]["counters"][k], err_msg=k)
    new, old = runs["new"][0].stats(), runs["old"][0].stats()
    assert new["synapses_formed"] > 0 and new["synapses_deleted"] > 0
    assert new["tree_nodes_downloaded"] == 0
    assert (old["tree_nodes_downloaded"] > 0) == (num_ranks > 1)


def test_vmap_reference_equals_the_mesh(jax_ref):
    """The vmap reference of the old algorithm against the JAX Simulator on
    four host devices: edge tables and every rank's counters equal after
    every chunk."""
    tr.assert_mesh_equals_vmap(*jax_ref["mesh"], jax_ref["runs"][4][0])
