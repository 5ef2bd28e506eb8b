"""The health verdict's matrix on the port's ``Simulator.probe_health``:
each monitored fault planted alone (every neuron field x NaN / +-Inf, the
positions, a half-edge orphaned, the synapse census off the conservation
bound, and an overflow that masks the census checks) and reported alone,
at one rank against the JAX Simulator's ``probe_health`` on the same state
(carried across by a port checkpoint restored into JAX), and at four ranks
(``dist.LocalComm``) with the fault on one rank, where the psum'd verdict
must still see it. The probe leaves the state's gauges as they were.

Tolerances: none; the flags are bit masks and must be equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.sim.api import Simulator as JSim
from repro_torch.checkpoint import manager
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.sim.api import Simulator
from repro_torch.telemetry import metrics as tm

SMALL = dict(neurons_per_rank=32, local_levels=3, frontier_cap=32,
             max_synapses=8, rate_period=10, requests_cap_factor=100,
             subs_cap_factor=100)

NEURON_CASES = [(f, bad) for f in ("v", "u", "calcium", "rate")
                for bad in (np.nan, np.inf, -np.inf)]
CASES = ([(f"{f}={bad}", f, bad) for f, bad in NEURON_CASES]
         + [("positions=nan", "positions", np.nan),
            ("positions=inf", "positions", np.inf),
            ("asymmetry", "in_edges", None),
            ("conservation", "synapses_formed", None),
            ("overflow_masks", "request_overflow", None)])
FOUR = [c for c in CASES
        if c[0].endswith("nan") or c[0] in ("asymmetry", "conservation")]
WANT = {"conservation": tm.HEALTH_CONSERVATION, "overflow_masks": 0}


def _check(name, flags):
    """The fault's bit is set (an orphaned half-edge may also move the
    census off the conservation bound, as in the JAX package's matrix)."""
    if name == "asymmetry":
        assert flags & tm.HEALTH_ASYMMETRY
        assert not flags & tm.HEALTH_NONFINITE
    else:
        assert flags == WANT.get(name, tm.HEALTH_NONFINITE)


def _copy(state):
    return manager.map_leaves(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def _plant(state, name, field, bad, row):
    """A copy of the global ``state`` with one fault at neuron row ``row``
    (an orphaned half-edge: the first live in-edge from that row on; a
    counter: the rank holding that row)."""
    st = _copy(state)
    n = SMALL["neurons_per_rank"]
    if name == "asymmetry":
        live = torch.nonzero(st.in_edges[row:] >= 0)[0]
        st.in_edges[row + int(live[0]), int(live[1])] = -1
    elif name in ("conservation", "overflow_masks"):
        st.stats.counters["synapses_formed"][row // n] += 10
        if name == "overflow_masks":
            st.stats.counters["request_overflow"][row // n] += 1
    elif field == "positions":
        st.positions[row, 2] = float(bad)
    else:
        getattr(st.neurons, field)[row] = float(bad)
    return st


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The port after two chunks at R=1 (probe 0) and a JAX Simulator of the
    same config to judge the same states."""
    sim = Simulator(BrainConfig(**SMALL), device="cpu")
    sim.run(2)
    assert sim.probe_health() == 0
    jsim = JSim.from_config(JConfig(**SMALL))
    return sim, _copy(sim.state), jsim, tmp_path_factory.mktemp("health")


@pytest.fixture(scope="module")
def four_ranks():
    sim = Simulator(BrainConfig(**SMALL), num_ranks=4, device="cpu")
    sim.run(2)
    assert sim.probe_health() == 0
    return sim, _copy(sim.state)


def _probe(sim, state):
    """``probe_health`` of ``state`` on ``sim``; the gauges as they were."""
    sim.state = state
    before = sim.health()
    flags = sim.probe_health()
    assert sim.health() == before
    return flags


@pytest.mark.parametrize("name,field,bad", CASES, ids=[c[0] for c in CASES])
def test_health_matrix_against_jax(one_rank, name, field, bad):
    sim, clean, jsim, root = one_rank
    flags = _probe(sim, _plant(clean, name, field, bad,
                               row=SMALL["neurons_per_rank"] // 2))
    _check(name, flags)
    path = str(root / name)
    step = sim.save(path)
    jsim._state, _ = jmanager.restore(path, step,
                                      jax.eval_shape(jsim.init_fn))
    assert jsim.probe_health() == flags


@pytest.mark.parametrize("name,field,bad", FOUR, ids=[c[0] for c in FOUR])
def test_health_matrix_four_ranks(four_ranks, name, field, bad):
    """The fault on rank 2's rows only: the verdict, psum'd over the four
    ranks, flags it on every rank."""
    sim, clean = four_ranks
    n = SMALL["neurons_per_rank"]
    _check(name, _probe(sim, _plant(clean, name, field, bad,
                                    row=2 * n + n // 2)))


def test_probe_leaves_the_gauges_and_the_next_chunk(one_rank):
    """A probe of a healthy state changes nothing: the next chunk from it
    is bitwise the chunk without the probe, gauges included."""
    sim, clean, _, _ = one_rank
    sim.state = _copy(clean)
    sim.probe_health()
    a = sim.step()
    sim.state = _copy(clean)
    b = sim.step()
    for (k, x), (_, y) in zip(manager._flatten(a), manager._flatten(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
