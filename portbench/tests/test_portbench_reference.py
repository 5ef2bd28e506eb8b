"""The plain references against the port on the CPU: the brain's state
bit for bit at the SMOKE_CONFIG sizes (the port's plain lowerings), and
the qwen2-7b smoke model's losses, first gradients and changes within the
stated small-size tolerances."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import LM_SMALL_LIMITS, small_run


def _snap(st):
    nd = st.neurons
    d = {k: getattr(nd, k).clone() for k in
         ("v", "u", "calcium", "ax_elements", "de_elements", "spiked",
          "spike_count", "rate", "is_excitatory")}
    d.update(out_edges=st.out_edges.clone(), in_edges=st.in_edges.clone(),
             positions=st.positions.clone(),
             rates_table=st.rates_table.clone(), chunk=st.chunk)
    return d


@pytest.mark.parametrize("lesion", [False, True])
def test_brain_reference_equals_port_at_smoke(lesion):
    from repro_torch.configs.msp_brain import SMOKE_CONFIG
    from repro_torch.scenarios import library, observables
    from repro_torch.sim.api import Simulator
    from portbench.reference import msp
    cfg = dataclasses.replace(SMOKE_CONFIG, seed=2 ** 31 + 11)
    rcfg = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    rcfg["leaf_members_cap"] = 4
    scen = library.lesion_rewiring() if lesion else None
    rscen = {"regions": [{"name": "core", "lo": [0.0, 0.0, 0.0],
                          "hi": [0.5, 1.0, 1.0]}],
             "events": [{"kind": "lesion", "region": "core", "t": 1000}]} \
        if lesion else None
    sim = Simulator.from_config(cfg, scenario=scen, device="cpu")
    sim.init()
    ref = msp.init_state(rcfg, torch.device("cpu"), rscen)
    assert sum(msp.state_mismatches(_snap(sim.state), ref).values()) == 0
    rec = observables.init_recorder(12, 2 if lesion else 1, device="cpu")
    for c in range(12):
        _, rec = sim.run(1, recorder=rec)
        ref = msp.chunk(ref, rcfg, rscen)
        bad = {k: v for k, v in msp.state_mismatches(_snap(sim.state),
                                                      ref).items() if v}
        assert not bad, (c, bad)
        row = msp.record_row(ref, rcfg, rscen)
        assert all(msp.mismatches(getattr(rec, f)[c], row[f]) == 0
                   for f in row), c
    assert int((ref["in_edges"] >= 0).sum()) > 0


def test_lm_reference_against_port_at_smoke():
    from portbench.bench import harness
    r = small_run("qwen2-7b-train.s4096", seed=3)
    line = harness.run_cell(r)
    got = {k: v["value"] for k, v in line["compared"].items()}
    assert got.keys() == LM_SMALL_LIMITS.keys()
    for k, lim in LM_SMALL_LIMITS.items():
        assert got[k] <= lim, (k, got[k])
    prog, want = r.readings["program"], r.readings["reference"]
    assert len(prog["grad"]) == len(want["grad"]) == 15
    # three steps from the same random init: the losses near ln V
    assert all(abs(x - 6.238) < 1.0 for x in want["loss"])
