"""The dynamic drive (``phases.DynamicParams``, ``Simulator.step_with``,
``dyn_compile_count``) and the rate-assimilation loop built on it
(``repro_torch.workloads.assimilate``), in the port against the JAX
package's, at ``SMOKE_CONFIG`` with ``requests_cap_factor=1000`` as
``tests/test_workloads.py`` runs them.

Tolerances: ``step_with`` of a zero drive is bitwise ``step()``; under a
non-zero drive (at ``_torch_ranks.SMALL``, 25-step windows) the edge
tables, counters, rates and element counts equal JAX's and v, u and calcium
are within 2e-3 x max(|x|, 1) (``_torch_ranks.FLOAT_TOL``; over one
100-step window of ``SMOKE_CONFIG`` the drift is already 2.8e-3 in u with no
drive at all, from the few-ulp difference of the Box-Muller noise); the assimilation's per-bucket mean rates are
within 2e-3 of JAX's over the first four chunks (a bucket's mean moves by
0.01 / its size when one neuron's window count differs by one spike).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as tr
from repro.configs.msp_brain import SMOKE_CONFIG as JSMOKE
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.sim import phases as jphases
from repro.sim.api import Simulator as JSim
from repro.workloads import assimilate as jwas
from repro_torch import convert
from repro_torch.configs.msp_brain import SMOKE_CONFIG
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.runtime import chaos
from repro_torch.sim import phases as tphases
from repro_torch.sim.api import Simulator as TSim
from repro_torch.workloads import assimilate as twas

CFG = dataclasses.replace(SMOKE_CONFIG, requests_cap_factor=1000)
JCFG = dataclasses.replace(JSMOKE, requests_cap_factor=1000)
FUSED = dataclasses.replace(CFG, **tr.FUSED)
DRIVES = ([0.7, -0.4], [1.5, 0.25], [-2.0, 0.0])


def _scenario():
    return twas.default_scenario()


def _snapshot(st) -> dict:
    return convert.state_to_numpy(st)


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("cfg", [CFG, FUSED], ids=["reference", "fused"])
def test_step_with_zero_drive_is_step(cfg, ranks):
    """``DynamicParams.zeros`` through ``step_with`` is bitwise ``step()``,
    at one rank and at four (every rank's context takes the drive): the
    dynamic path adds an input surface, not dynamics."""
    a = TSim.from_config(cfg, scenario=_scenario(), num_ranks=ranks,
                         device="cpu")
    b = TSim.from_config(cfg, scenario=_scenario(), num_ranks=ranks,
                         device="cpu")
    dyn = tphases.DynamicParams.zeros(2, device="cpu")
    for _ in range(2):
        sa, sb = _snapshot(a.step()), _snapshot(b.step_with(dyn))
        for f in ("out_edges", "in_edges"):
            np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
        for f, x in sa["neurons"].items():
            np.testing.assert_array_equal(x, sb["neurons"][f], err_msg=f)
    assert b.dyn_compile_count() == 1 and a.dyn_compile_count() == 0


def test_non_zero_drive_matches_jax():
    """Three chunks under changing drives, fed to JAX's ``step_with`` and
    the port's: integer results equal, the activity floats within
    FLOAT_TOL, and the drive reaches exactly its bucket."""
    from repro.scenarios.protocol import Scenario
    from repro.scenarios.regions import Region as JRegion
    jscn = Scenario(name="assimilation", regions=(
        JRegion("driven", lo=(0.0, 0.0, 0.0), hi=(0.5, 1.0, 1.0)),),
        num_chunks=12)
    jsim = JSim.from_config(JConfig(**tr.SMALL), scenario=jscn)
    small = TConfig(**tr.SMALL, **tr.FUSED)
    tsim = TSim.from_config(small, scenario=_scenario(), device="cpu")
    for c, drive in enumerate(DRIVES):
        want = jax.device_get(jsim.step_with(jphases.DynamicParams(
            region_drive=jnp.asarray(drive, jnp.float32))))
        got = _snapshot(tsim.step_with(tphases.DynamicParams(
            region_drive=torch.tensor(drive, dtype=torch.float32))))
        for f in ("out_edges", "in_edges"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                          err_msg=f"chunk {c}: {f}")
        for k, v in want.stats.counters.items():
            np.testing.assert_array_equal(got["stats"]["counters"][k],
                                          np.asarray(v), err_msg=k)
        for f in ("rate", "ax_elements", "de_elements", "spike_count"):
            np.testing.assert_array_equal(got["neurons"][f], np.asarray(
                getattr(want.neurons, f)), err_msg=f"chunk {c}: {f}")
        for f in ("v", "u", "calcium"):
            w = np.asarray(getattr(want.neurons, f))
            err = np.abs(got["neurons"][f] - w) / np.maximum(np.abs(w), 1.0)
            assert err.max() <= tr.FLOAT_TOL, (c, f, err.max())
    assert tsim.dyn_compile_count() == 1 == jsim.dyn_compile_count()
    # the drive reaches exactly its bucket: in the first chunk (no synapses
    # yet) the driven half's v moves, the rest's is bitwise unchanged
    zero = TSim.from_config(small, scenario=_scenario(), device="cpu")
    driven = TSim.from_config(small, scenario=_scenario(), device="cpu")
    z = zero.step()
    d = driven.step_with(tphases.DynamicParams(
        region_drive=torch.tensor([3.0, 0.0])))
    inside = z.positions[:, 0] < 0.5
    assert bool((z.neurons.v != d.neurons.v)[inside].all())
    assert torch.equal(z.neurons.v[~inside], d.neurons.v[~inside])


def test_drive_reaches_every_rank():
    """At four ranks (``LocalComm``) the drive reaches each rank's driven
    neurons and no other: in the first chunk (no synapses yet) v moves in
    the driven half of every rank's block and is bitwise unchanged
    elsewhere."""
    small = TConfig(**tr.SMALL, **tr.FUSED)
    z = TSim.from_config(small, scenario=_scenario(), num_ranks=4,
                         device="cpu").step()
    d = TSim.from_config(small, scenario=_scenario(), num_ranks=4,
                         device="cpu").step_with(tphases.DynamicParams(
                             region_drive=torch.tensor([3.0, 0.0])))
    inside = z.positions[:, 0] < 0.5
    assert bool(inside.reshape(4, -1).any(1).all())
    moved = (z.neurons.v != d.neurons.v).reshape(4, -1)
    assert all(bool(m[i].all()) for m, i in zip(moved, inside.reshape(4, -1)))
    assert torch.equal(z.neurons.v[~inside], d.neurons.v[~inside])


def test_dyn_compile_count_counts_signatures():
    """New values keep one signature (a numpy leaf included: it goes up as
    an f32 tensor on the simulator's device); a leaf of another shape is a
    second one."""
    sim = TSim.from_config(CFG, scenario=_scenario(), device="cpu")
    assert sim.dyn_compile_count() == 0
    for drive in DRIVES:
        sim.step_with(tphases.DynamicParams(
            region_drive=torch.tensor(drive, dtype=torch.float32)))
    sim.step_with(tphases.DynamicParams(
        region_drive=np.asarray([0.1, 0.2], np.float32)))
    assert sim.dyn_compile_count() == 1
    sim.step_with(tphases.DynamicParams(region_drive=torch.zeros(3)))
    assert sim.dyn_compile_count() == 2


def test_assimilation_converges_with_one_signature():
    res, _ = twas.run_assimilation(CFG, chunks=10, target_rate=0.02,
                                   device="cpu")
    assert res.compile_count == 1
    assert res.abs_err[-1] < res.abs_err[0], (res.abs_err[0],
                                              res.abs_err[-1])
    assert res.abs_err[-1] < 0.01
    assert np.isnan(res.target[:, 1]).all()


def test_assimilation_drop_region_recovery():
    hook = chaos.drop_region_input("driven", chunks=2, after_chunk=4)
    res, _ = twas.run_assimilation(CFG, chunks=14, hooks=[hook],
                                   device="cpu")
    assert res.compile_count == 1
    dropped = res.measured[4:6, 0]
    assert (dropped < res.measured[3, 0] * 0.5).all(), res.measured[:, 0]
    np.testing.assert_allclose(res.drive[4:6, 0], -CFG.background_mean)
    assert res.abs_err[-1] < res.abs_err[5], res.abs_err


def test_assimilation_measured_rates_against_jax():
    """The first four chunks of the loop: the drives, measured rates and
    errors of the port within 2e-3 of JAX's (printed: whether they were
    exactly equal)."""
    want, _ = jwas.run_assimilation(JCFG, chunks=4)
    got, _ = twas.run_assimilation(FUSED, chunks=4, device="cpu")
    print("measured exactly equal:",
          np.array_equal(got.measured, want.measured))
    np.testing.assert_allclose(got.measured, want.measured, rtol=0,
                               atol=2e-3)
    # the drive integrates gain x error and the clip moves no two values
    # apart: row t differs by at most gain x the measured differences of
    # the rows before it (f32 rounding aside)
    diff = np.abs(got.measured[:, 0] - want.measured[:, 0])
    bound = 120.0 * np.concatenate([[0.0], np.cumsum(diff)[:-1]])
    assert (np.abs(got.drive[:, 0] - want.drive[:, 0])
            <= bound + 1e-5).all(), (got.drive, want.drive)
    np.testing.assert_array_equal(got.drive[:, 1], want.drive[:, 1])
    np.testing.assert_allclose(got.abs_err, want.abs_err, rtol=0, atol=2e-3)
    assert got.compile_count == want.compile_count == 1
