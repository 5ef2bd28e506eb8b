"""The port's scenario modules (regions, protocol, populations, observables,
library) against the JAX package's, from the same numpy inputs, and the
scenario path of the Simulator against the JAX Simulator through a lesion.

Tolerances: masks, region ids, tables, counts and edge tables are equal.
The recorder's means (calcium, rate per region) are f32 sums taken in
another order (one masked sum per region here, a neuron-order scatter-add
there): within 1e-6 relative. The whole-run comparison holds counters, edge
tables and the recorder's integer rows equal up to the first chunk touched
by a spike near-tie, as in tests/test_torch_sim.py (none seen: the run below
agrees in every chunk)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.scenarios import library as jlib
from repro.scenarios import observables as jobs
from repro.scenarios import populations as jpops
from repro.scenarios import protocol as jproto
from repro.scenarios import regions as jreg
from repro.sim.api import Simulator as JSim
from repro_torch import convert
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.scenarios import library as tlib
from repro_torch.scenarios import observables as tobs
from repro_torch.scenarios import populations as tpops
from repro_torch.scenarios import protocol as tproto
from repro_torch.scenarios import regions as treg
from repro_torch.sim.api import Simulator as TSim

FUSED = dict(activity_impl="fused", connectivity_impl="fused",
             tree_impl="fused", apply_impl="fused")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jscn():
    """A protocol with every event kind, overlapping windows, a Recover
    and per-region drive overrides."""
    regions = (jreg.Region("a", (0.0, 0.0, 0.0), (0.5, 0.5, 1.0),
                           bg_mean=6.0),
               jreg.Region("b", (0.25, 0.0, 0.0), (1.0, 0.75, 0.5),
                           bg_std=2.0))
    events = (jproto.Stimulate("a", 4.0, 100, 300),
              jproto.Stimulate("b", -1.5, 250, 260),
              jproto.Lesion("b", 200), jproto.Recover("b", 280),
              jproto.Lesion("a", 290))
    return jproto.Scenario("mixed", regions=regions, events=events,
                           num_chunks=3)


def _positions(n=200, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    pos[:20] = np.float32(0.5)                    # on region borders
    pos[20:30] = np.float32(0.25)
    return pos


def test_scenario_from_reference_copies_every_field():
    for name in jlib.SCENARIOS:
        got = convert.scenario_from_reference(jlib.get_scenario(name))
        assert got == tlib.get_scenario(name)
    got = convert.scenario_from_reference(_jscn())
    assert [type(e).__name__ for e in got.events] == \
        ["Stimulate", "Stimulate", "Lesion", "Recover", "Lesion"]
    assert got.regions[0].bg_mean == 6.0 and got.num_chunks == 3


def test_region_masks_ids_and_background_tables():
    jscn = _jscn()
    tscn = convert.scenario_from_reference(jscn)
    pos = _positions()
    for jr, tr in zip(jscn.regions, tscn.regions):
        np.testing.assert_array_equal(
            np.asarray(jreg.region_mask(jnp.asarray(pos), jr)),
            treg.region_mask(_t(pos), tr).numpy())
    want = np.asarray(jreg.assign_regions(jnp.asarray(pos), jscn.regions))
    got = treg.assign_regions(_t(pos), tscn.regions)
    np.testing.assert_array_equal(want, got.numpy())
    assert set(got.tolist()) == {0, 1, 2}
    assert treg.num_buckets(tscn.regions) == 3
    np.testing.assert_array_equal(
        np.asarray(jreg.region_counts(jnp.asarray(want), 3)),
        treg.region_counts(got, 3).numpy())
    jm, js = jreg.background_tables(jnp.asarray(pos), jscn.regions,
                                    JConfig())
    tm, ts = treg.background_tables(_t(pos), tscn.regions, TConfig())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert treg.background_tables(_t(pos), (), TConfig()) == (5.0, 1.0)


def test_region_connectome():
    rng = np.random.default_rng(2)
    n, s = 90, 6
    edges = rng.integers(-1, n, (n, s)).astype(np.int32)
    rid = rng.integers(0, 3, n).astype(np.int32)
    want = jreg.region_connectome(jnp.asarray(edges), jnp.asarray(rid),
                                  jnp.asarray(rid), 3)
    got = treg.region_connectome(_t(edges), _t(rid), _t(rid), 3)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.sum() == (edges >= 0).sum()


@pytest.mark.parametrize("step", [0, 99, 100, 200, 255, 279, 280, 290, 10 ** 6])
def test_protocol_tables_and_alive_mask(step):
    jscn = _jscn()
    tscn = convert.scenario_from_reference(jscn)
    pos = _positions(seed=1)
    jp, tp = jnp.asarray(pos), _t(pos)
    js = jproto.stim_tables(jscn.events, jscn.regions, jp)
    ts = tproto.stim_tables(tscn.events, tscn.regions, tp)
    np.testing.assert_array_equal(np.asarray(js[0]), ts[0].numpy())
    assert js[1] == ts[1]
    jl = jproto.lesion_tables(jscn.events, jscn.regions, jp)
    tl = tproto.lesion_tables(tscn.events, tscn.regions, tp)
    np.testing.assert_array_equal(np.asarray(jl[0]), tl[0].numpy())
    assert jl[1] == tl[1] == ((200, 280), (290, 1 << 30))
    np.testing.assert_array_equal(
        np.asarray(jproto.alive_mask(jscn.events, jscn.regions, jp,
                                     jnp.int32(step))),
        tproto.alive_mask(tscn.events, tscn.regions, tp, step).numpy())
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(jproto.stim_drive(
            jscn.events, jscn.regions, jp, jnp.int32(step))), (pos.shape[0],)),
        np.broadcast_to(tproto.stim_drive(tscn.events, tscn.regions, tp,
                                          step).numpy(), (pos.shape[0],)))
    assert tproto.has_lesions(tscn) and not tproto.has_lesions(None)
    assert tproto.alive_mask((), (), tp, step) is None
    assert tproto.stim_tables((), (), tp) is None


@pytest.mark.parametrize("name", sorted(jlib.SCENARIOS))
def test_population_table_for_scenario(name):
    jt = jpops.table_for(JConfig(), jlib.get_scenario(name), 100)
    tt = tpops.table_for(TConfig(), tlib.get_scenario(name), 100)
    for f in jt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f).numpy(), err_msg=f)


def test_record_and_flush():
    jscn = _jscn()
    tscn = convert.scenario_from_reference(jscn)
    rng = np.random.default_rng(3)
    n, s, cap = 150, 6, 3
    jrec = jobs.init_recorder(cap, 3)
    trec = tobs.init_recorder(cap, 3, device="cpu")
    for k in range(5):                            # wraps the ring
        pos = _positions(n, seed=k)
        ca = rng.random(n).astype(np.float32)
        rate = (rng.random(n) * 0.6).astype(np.float32)
        edges = rng.integers(-1, n, (n, s)).astype(np.int32)
        alive = rng.random(n) < 0.7 if k % 2 else None
        jrec = jobs.record(jrec, jnp.asarray(pos), jnp.asarray(ca),
                           jnp.asarray(rate), jnp.asarray(edges),
                           jscn.regions,
                           None if alive is None else jnp.asarray(alive))
        trec = tobs.record(trec, _t(pos), _t(ca), _t(rate), _t(edges),
                           tscn.regions, None if alive is None else _t(alive))
    want, got = jobs.flush(jrec), tobs.flush(trec)
    assert want["num_recorded"] == got["num_recorded"] == 5
    for k in ("synapses", "alive", "connectome", "rate_hist"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    for k in ("calcium", "rate"):
        np.testing.assert_allclose(want[k], got[k], rtol=1e-6, atol=0,
                                   err_msg=k)


def _lesion_scn(t=200):
    return dataclasses.replace(jlib.lesion_rewiring(),
                               events=(jproto.Lesion("core", t=t),))


def test_lesion_run_against_jax_simulator():
    """All five lowerings fused on both sides (JAX in interpret mode),
    lesion at step 200: chunk by chunk through it, counters, edge tables
    and the recorder's integer rows equal."""
    chunks = 4
    jscn = _lesion_scn()
    tscn = convert.scenario_from_reference(jscn)
    jsim = JSim.from_config(dataclasses.replace(jlib.SMOKE_SCENARIO_CONFIG,
                                                **FUSED), scenario=jscn)
    tsim = TSim.from_config(dataclasses.replace(tlib.SMOKE_SCENARIO_CONFIG,
                                                **FUSED), scenario=tscn,
                            device="cpu")
    jrec = jobs.init_recorder(chunks, 2)
    trec = tobs.init_recorder(chunks, 2, device="cpu")
    first_divergence = None
    for c in range(chunks):
        jst, jrec = jsim.run(1, recorder=jrec)
        _, trec = tsim.run(1, recorder=trec)
        want = {k: float(np.asarray(v).sum()) for k, v in
                jax.device_get(jst.stats.counters).items()}
        got = tsim.stats()
        if any(want[k] != got[k] for k in want):
            first_divergence = c
            break
        js = jax.device_get(jst)
        np.testing.assert_array_equal(np.asarray(js.in_edges),
                                      tsim.state.in_edges.numpy())
        np.testing.assert_array_equal(np.asarray(js.out_edges),
                                      tsim.state.out_edges.numpy())
        jh, th = jobs.flush(jrec), tobs.flush(trec)
        for k in ("synapses", "alive", "connectome", "rate_hist"):
            np.testing.assert_array_equal(jh[k], th[k], err_msg=k)
        np.testing.assert_allclose(jh["calcium"], th["calcium"], rtol=1e-5)
    print(f"counters equal for {chunks if first_divergence is None else first_divergence} of {chunks} chunks")
    assert first_divergence is None or first_divergence >= 2
    th = tobs.flush(trec)
    assert (th["alive"][1:, 0] == 0).all() and th["alive"][0, 0] > 0
    assert (th["synapses"][1:, 0] == 0).all()
    assert tsim.stats()["synapses_deleted"] > 0
    assert tsim.health()["health_flags"] == 0


@pytest.mark.parametrize("name", sorted(tlib.SCENARIOS))
def test_fused_equals_reference_under_each_scenario(name):
    """Inside the port, bitwise: all five lowerings fused against all five
    reference, with the event times scaled into four chunks."""
    scn = tlib.get_scenario(name)
    scn = dataclasses.replace(scn, events=tuple(
        dataclasses.replace(e, t=e.t // 5) if isinstance(e, tproto.Lesion)
        else dataclasses.replace(e, t0=e.t0 // 5, t1=e.t1 // 5)
        for e in scn.events))
    out = {}
    for impl in ("reference", "fused"):
        cfg = dataclasses.replace(tlib.SMOKE_SCENARIO_CONFIG,
                                  **{k: impl for k in FUSED})
        sim = TSim.from_config(cfg, scenario=scn, device="cpu")
        st, rec = sim.run(4, recorder=tobs.init_recorder(
            4, len(scn.regions) + 1, device="cpu"))
        out[impl] = (st, tobs.flush(rec), sim.stats())
    a, b = out["reference"], out["fused"]
    for f in a[0].neurons._fields:
        assert torch.equal(getattr(a[0].neurons, f),
                           getattr(b[0].neurons, f)), f
    assert torch.equal(a[0].in_edges, b[0].in_edges)
    assert torch.equal(a[0].out_edges, b[0].out_edges)
    for k in tobs.FIELDS:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)
    assert {k: v for k, v in a[2].items() if not k.startswith("launches/")} \
        == {k: v for k, v in b[2].items() if not k.startswith("launches/")}
    assert b[2]["synapses_formed"] > 0


def test_run_scenario_returns_the_flushed_history():
    scn = dataclasses.replace(tlib.focal_stimulation(), events=(
        tproto.Stimulate("focus", 4.0, 50, 150),))
    st, hist = tlib.run_scenario(scn, num_chunks=2, device="cpu")
    assert st.chunk == 2 and hist["num_recorded"] == 2
    assert hist["alive"].shape == (2, 2) and hist["connectome"].shape == \
        (2, 2, 2)
    with pytest.raises(KeyError, match="unknown scenario"):
        tlib.get_scenario("nope")
