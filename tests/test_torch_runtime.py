"""The port's fault-tolerant runner (``repro_torch.runtime``) at one rank:
the simulator half of the JAX package's ``tests/test_runtime.py``. The
heartbeat file, the runner against an uninterrupted run, NaN rollback,
preempt and resume, a corrupt newest checkpoint skipped, and the lifecycle
counts of a script with every fault against the JAX runner's on the same
script.

Tolerances: the runner's final state is bitwise the uninterrupted run's (the
port against itself); the lifecycle counts equal the JAX runner's exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.runtime import chaos as jchaos
from repro.runtime.sim_runner import SimRunnerConfig as JRunnerConfig
from repro.runtime.sim_runner import SimulationRunner as JRunner
from repro_torch.checkpoint import manager
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.runtime import chaos, fault_tolerance as ft
from repro_torch.runtime.sim_runner import SimRunnerConfig, SimulationRunner
from repro_torch.sim.api import Simulator

SMALL = dict(neurons_per_rank=32, local_levels=3, frontier_cap=32,
             max_synapses=8, rate_period=10, requests_cap_factor=100,
             subs_cap_factor=100)


def _assert_states_equal(a, b):
    la, lb = manager._flatten(a), manager._flatten(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            assert x == y, k


def _runner(ck, cfg, **kw):
    return SimulationRunner(SimRunnerConfig(ck, ckpt_every=2, **kw), cfg=cfg,
                            device="cpu")


@pytest.fixture(scope="module")
def small_cfg():
    return BrainConfig(**SMALL)


@pytest.fixture(scope="module")
def ref_state(small_cfg):
    """The final state of an uninterrupted 6-chunk run (the reference of
    every recovery test below)."""
    sim = Simulator(small_cfg, device="cpu")
    sim.run(6)
    return sim.state


# ---------------------------------------------------------------- heartbeat
def test_heartbeat_write_is_atomic(tmp_path):
    """write_heartbeat never leaves a torn file or a stray temp."""
    hb = str(tmp_path / "hb.json")
    for step in range(5):
        ft.write_heartbeat(hb, {"step": step})
        with open(hb) as f:
            d = json.load(f)
        assert d["step"] == step and "t" in d
    assert os.listdir(tmp_path) == ["hb.json"]


def test_read_heartbeat_fresh_stale_missing(tmp_path):
    hb = str(tmp_path / "hb.json")
    assert ft.read_heartbeat(hb, max_age_s=1.0) == (None, None, "missing")
    ft.write_heartbeat(hb, {"chunk": 7})
    payload, age, verdict = ft.read_heartbeat(hb, max_age_s=60.0)
    assert verdict == "fresh" and payload["chunk"] == 7 and age >= 0
    stale_now = payload["t"] + 120.0
    payload, age, verdict = ft.read_heartbeat(hb, max_age_s=60.0,
                                              now=stale_now)
    assert verdict == "stale" and age > 60.0
    assert ft.read_heartbeat(hb, now=stale_now)[2] == "fresh"
    with open(hb, "w") as f:
        f.write("{not json")
    assert ft.read_heartbeat(hb)[2] == "missing"


def _plant_stale_beat(hb):
    ft.write_heartbeat(hb, {"chunk": 0})
    with open(hb) as f:
        old = json.load(f)
    old["t"] -= 3600.0
    with open(hb, "w") as f:
        json.dump(old, f)


def test_runner_counts_stale_heartbeat(tmp_path, small_cfg):
    hb = str(tmp_path / "hb.json")
    _plant_stale_beat(hb)
    r = SimulationRunner(
        SimRunnerConfig(str(tmp_path / "ck"), ckpt_every=1,
                        heartbeat_path=hb, heartbeat_max_age_s=60.0),
        cfg=small_cfg, device="cpu")
    assert r.run(2) == "done"
    assert r.sim.lifecycle["heartbeat_stale"] == 1   # only the planted beat
    assert r.sim.stats()["heartbeat_stale"] == 1
    payload, _, verdict = ft.read_heartbeat(hb, max_age_s=60.0)
    assert verdict == "fresh" and payload["chunk"] == 2


# ---------------------------------------------------------------- runner
def test_runner_matches_plain_run(tmp_path, small_cfg, ref_state):
    r = _runner(str(tmp_path / "ck"), small_cfg)
    assert r.run(6) == "done"
    _assert_states_equal(r.sim.state, ref_state)
    s = r.sim.stats()
    assert s["checkpoint_saves"] >= 3 and s["rollbacks"] == 0
    assert manager.steps_available(str(tmp_path / "ck")) == [2, 4, 6]
    h = r.sim.health()
    assert h["health_flags"] == 0
    assert h["out_edges_live"] == h["in_edges_live"] > 0


def test_runner_nan_rollback_recovers_bit_identical(tmp_path, small_cfg,
                                                    ref_state):
    r = _runner(str(tmp_path / "ck"), small_cfg)
    r.chaos_hooks.append(chaos.poison_nan_once(field="v", after_chunk=3))
    assert r.run(6) == "done"
    assert r.sim.lifecycle["rollbacks"] >= 1
    _assert_states_equal(r.sim.state, ref_state)


def test_runner_preempt_resume_bit_identical(tmp_path, small_cfg,
                                             ref_state):
    ck = str(tmp_path / "ck")
    r = _runner(ck, small_cfg)
    r.chaos_hooks.append(chaos.preempt_after(4))
    assert r.run(6) == "preempted"
    r2 = _runner(ck, small_cfg)
    assert r2.sim.chunk == 4 and r2.sim.lifecycle["restarts"] == 1
    assert r2.run(6 - r2.sim.chunk) == "done"
    _assert_states_equal(r2.sim.state, ref_state)


def test_runner_resume_skips_corrupt_newest(tmp_path, small_cfg):
    ck = str(tmp_path / "ck")
    assert _runner(ck, small_cfg).run(4) == "done"
    newest = chaos.corrupt_checkpoint(ck, mode="truncate")
    r2 = _runner(ck, small_cfg)
    assert r2.sim.chunk < newest and r2.sim.lifecycle["restarts"] == 1


def test_runner_takes_exactly_one_of_cfg_and_sim(tmp_path, small_cfg):
    with pytest.raises(ValueError, match="exactly one"):
        SimulationRunner(SimRunnerConfig(str(tmp_path)), device="cpu")
    sim = Simulator(small_cfg, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        SimulationRunner(SimRunnerConfig(str(tmp_path)), cfg=small_cfg,
                         sim=sim)
    r = SimulationRunner(SimRunnerConfig(str(tmp_path)), sim=sim)
    assert r.sim is sim


# ------------------------------------------------- the JAX runner's script
def _script(runner_cls, cfg_cls, chaos_mod, root, **kw):
    """Every runner fault in one script: a stale planted heartbeat, NaN
    poisoning after chunk 3 and preemption at chunk 4 (in the same
    interval), then a fresh runner resuming and finishing at chunk 6.
    Returns the lifecycle after each runner, the return values and the
    checkpoint steps on disk."""
    ck, hb = os.path.join(root, "ck"), os.path.join(root, "hb.json")
    os.makedirs(root)
    _plant_stale_beat(hb)

    def make():
        return runner_cls(cfg_cls(ck, ckpt_every=2, heartbeat_path=hb,
                                  heartbeat_max_age_s=60.0), **kw)

    r = make()
    r.chaos_hooks.append(chaos_mod.poison_nan_once(field="v",
                                                   after_chunk=3))
    r.chaos_hooks.append(chaos_mod.preempt_after(4))
    first = r.run(6)
    life1 = dict(r.sim.lifecycle)
    r2 = make()
    resumed = dict(r2.sim.lifecycle)
    second = r2.run(6 - int(np.asarray(r2.sim.state.chunk)))
    steps = sorted(os.listdir(ck))
    return (first, second), (life1, resumed, dict(r2.sim.lifecycle)), steps


def test_lifecycle_counts_equal_the_jax_runners(tmp_path):
    """The same script of faults under the JAX runner and the port's: the
    same return values, the same lifecycle counts after each runner and
    after the resume, and the same checkpoint steps left on disk."""
    want = _script(JRunner, JRunnerConfig, jchaos, str(tmp_path / "jax"),
                   cfg=JConfig(**SMALL))
    got = _script(SimulationRunner, SimRunnerConfig, chaos,
                  str(tmp_path / "port"), cfg=BrainConfig(**SMALL),
                  device="cpu")
    assert got == want
    assert want[0] == ("preempted", "done")
    life = want[1][2]
    assert life["rollbacks"] >= 1 and life["restarts"] == 1
    assert life["heartbeat_stale"] == 1
