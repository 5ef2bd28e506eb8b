"""The scenario library and its runner (the port's copy of the JAX package's
``scenarios/library.py``).

  baseline_growth    heterogeneous sheet (RS / CH excitatory + FS
                     inhibitory) growing from an empty connectome.
  focal_stimulation  extra input current to a focal region mid-run.
  lesion_rewiring    a region dies mid-run: its synapses are retracted
                     (partners notified), then the survivors regrow.

``run_scenario`` drives one on the ``Simulator`` and returns the final state
and the flushed per-region recorder history.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.scenarios import observables
from repro_torch.scenarios.populations import population
from repro_torch.scenarios.protocol import Lesion, Scenario, Stimulate
from repro_torch.scenarios.regions import Region
from repro_torch.sim.api import Simulator

# smoke scale with overflow-free buffers, so a run is exactly the MSP
# dynamics (fused and reference lowerings are compared bitwise)
SMOKE_SCENARIO_CONFIG = dataclasses.replace(
    SMOKE_CONFIG, requests_cap_factor=1000)


def baseline_growth() -> Scenario:
    return Scenario(
        name="baseline_growth",
        populations=(
            population("exc-rs", 0.6, "RS"),
            population("exc-ch", 0.2, "CH"),
            population("inh-fs", 0.2, "FS", is_excitatory=False,
                       synapse_weight=30.0),
        ),
        regions=(),
        events=(),
        num_chunks=20)


def focal_stimulation() -> Scenario:
    return Scenario(
        name="focal_stimulation",
        regions=(Region("focus", lo=(0.0, 0.0, 0.0), hi=(0.5, 0.5, 1.0)),),
        events=(Stimulate("focus", amplitude=4.0, t0=500, t1=1500),),
        num_chunks=20)


def lesion_rewiring() -> Scenario:
    return Scenario(
        name="lesion_rewiring",
        regions=(Region("core", lo=(0.0, 0.0, 0.0), hi=(0.5, 1.0, 1.0)),),
        events=(Lesion("core", t=1000),),
        num_chunks=24)


SCENARIOS = {
    "baseline_growth": baseline_growth,
    "focal_stimulation": focal_stimulation,
    "lesion_rewiring": lesion_rewiring,
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}") from None


def run_scenario(scenario: Scenario, cfg=None, num_chunks: int = None,
                 recorder_cap: int = None, device=None):
    """Run a scenario end to end on the ``Simulator`` (on the card unless
    ``device`` says otherwise). Returns (final_state, history), the history
    the flushed recorder (oldest chunk first)."""
    cfg = cfg or SMOKE_SCENARIO_CONFIG
    num_chunks = num_chunks or scenario.num_chunks
    sim = Simulator.from_config(cfg, scenario=scenario, device=device)
    rec = observables.init_recorder(recorder_cap or num_chunks,
                                    len(scenario.regions) + 1,
                                    device=sim.device)
    st, rec = sim.run(num_chunks, recorder=rec)
    return st, observables.flush(rec)
