"""The port's runtime at four ranks: the multi-rank half of the JAX
package's ``tests/test_runtime.py`` (kill-and-resume, elastic R=4 -> R=2,
the degradation ladder), run on ``dist.LocalComm``, and the checkpoint and
the recorder under ``dist.ProcessGroupComm`` in four gloo processes.

Tolerances: bitwise throughout. Kill-and-resume equals the uninterrupted
run on every state leaf and counter; after an elastic restore the old and
the new connectivity algorithm form the same network (sorted rows and
``synapses_formed``) and sparse == dense on the physical state, as the JAX
package's own tests hold them; the ladder's new config equals the JAX
runner's ladder on the same counters; a process group's checkpoint and
recorder rows equal ``LocalComm``'s.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.configs.msp_brain import BrainConfig as JConfig
from repro.runtime import sim_runner as jsim_runner
from repro_torch.checkpoint import manager
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.runtime import chaos, elastic
from repro_torch.runtime.sim_runner import SimRunnerConfig, SimulationRunner
from repro_torch.scenarios import library, observables
from repro_torch.sim.api import Simulator
from repro_torch.telemetry import metrics as tm

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
R = 4
BASE = dict(neurons_per_rank=64, local_levels=3, frontier_cap=32,
            max_synapses=8, rate_period=10)
FUSED = dict(activity_impl="fused", connectivity_impl="fused",
             tree_impl="fused", apply_impl="fused")


def _assert_states_equal(a, b):
    la, lb = manager._flatten(a), manager._flatten(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("exchange,activity", [
    ("dense", "reference"), ("sparse", "reference"), ("dense", "fused"),
    ("sparse", "fused")])
def test_kill_resume_bit_identical_4rank(tmp_path, exchange, activity):
    """Killed after 2 of 4 chunks and resumed by a fresh runner == the
    uninterrupted run: every state leaf and every counter."""
    impl = FUSED if activity == "fused" else {}
    cfg = BrainConfig(**BASE, requests_cap_factor=100, subs_cap_factor=100,
                      rate_exchange=exchange, **impl)
    ref = Simulator(cfg, num_ranks=R, device="cpu")
    ref.run(4)
    ck = str(tmp_path / "ck")

    def runner():
        return SimulationRunner(SimRunnerConfig(ck, ckpt_every=1), cfg=cfg,
                                num_ranks=R, device="cpu")

    r = runner()
    r.chaos_hooks.append(chaos.preempt_after(2))
    assert r.run(4) == "preempted"
    r2 = runner()
    assert r2.sim.chunk == 2 and r2.sim.lifecycle["restarts"] == 1
    assert r2.run(4 - r2.sim.chunk) == "done"
    _assert_states_equal(ref.state, r2.sim.state)
    sa, sb = ref.stats(), r2.sim.stats()
    for k in tm.COUNTER_KEYS:
        assert sa[k] == sb[k], k


def test_elastic_shrink_4_to_2_old_new_identical(tmp_path):
    """A checkpoint written at R=4 restores at R=2: the global arrays as the
    writer left them, and old == new connectivity on the smaller group."""
    base = BrainConfig(**BASE, spike_alg="old", requests_cap_factor=1000)
    sim4 = Simulator(base, num_ranks=R, device="cpu")
    sim4.run(2)
    sim4.save(str(tmp_path))
    res = {}
    for alg in ("old", "new"):
        cfg2 = dataclasses.replace(base, neurons_per_rank=128,
                                   connectivity_alg=alg)
        sim2, step = elastic.remesh_restore_brain(str(tmp_path), cfg2,
                                                  num_ranks=2, device="cpu")
        assert step == 2 and sim2.num_ranks == 2
        assert sim2.lifecycle["checkpoint_restores"] == 1
        for name in ("out_edges", "in_edges", "positions"):
            assert torch.equal(getattr(sim4.state, name),
                               getattr(sim2.state, name)), name
        sim2.run(2)
        assert sim2.health()["health_flags"] == 0
        st = sim2.state
        res[alg] = (torch.sort(st.out_edges, 1)[0],
                    torch.sort(st.in_edges, 1)[0],
                    sim2.stats()["synapses_formed"])
    assert torch.equal(res["old"][0], res["new"][0])
    assert torch.equal(res["old"][1], res["new"][1])
    assert res["old"][2] == res["new"][2] > 0


def test_elastic_shrink_sparse_matches_dense(tmp_path):
    """The same sparse R=4 checkpoint restored at R=2 as sparse and as
    dense: the physical state bitwise equal after two more chunks (the
    rebuilt registry carries exactly the dense exchange's information)."""
    base = BrainConfig(**BASE, requests_cap_factor=100, subs_cap_factor=100,
                       rate_exchange="sparse")
    sim4 = Simulator(base, num_ranks=R, device="cpu")
    sim4.run(2)
    sim4.save(str(tmp_path))
    res = {}
    for exch in ("sparse", "dense"):
        cfg2 = dataclasses.replace(base, neurons_per_rank=128,
                                   rate_exchange=exch)
        sim2, _ = elastic.remesh_restore_brain(str(tmp_path), cfg2,
                                               num_ranks=2, device="cpu")
        sim2.run(2)
        st = sim2.state
        res[exch] = (st.neurons.v, st.neurons.calcium, st.neurons.rate,
                     st.out_edges, st.in_edges)
    for a, b in zip(res["sparse"], res["dense"]):
        assert torch.equal(a, b)


def test_elastic_refuses_growth(tmp_path):
    cfg = BrainConfig(**BASE)
    Simulator(cfg, num_ranks=2, device="cpu").save(str(tmp_path))
    with pytest.raises(ValueError, match="divide"):
        elastic.remesh_restore_brain(
            str(tmp_path), dataclasses.replace(cfg, neurons_per_rank=32),
            num_ranks=R, device="cpu")


def _jax_ladder(jcfg, num_ranks, stats_delta, **run_kw):
    """The config the JAX runner's ladder steps down to from ``jcfg`` on
    the given overflow increments: its ``_maybe_degrade`` run on a stand-in
    runner whose elastic restore only records the new config."""
    seen = {}

    def remesh(ckpt_dir, cfg, **kw):
        seen["cfg"] = cfg
        return types.SimpleNamespace(cfg=cfg, lifecycle={
            "degrade_events": 0}), 0

    stand_in = types.SimpleNamespace(
        cfg=jsim_runner.SimRunnerConfig("unused", overflow_patience=1,
                                        **run_kw),
        sim=types.SimpleNamespace(cfg=jcfg, num_ranks=num_ranks),
        _overflow_strikes=0, degrades=0, _last_saved_chunk=0,
        mesh_arg=None, scenario=None, _checkpoint=lambda: True,
        ckpt=types.SimpleNamespace(wait=lambda: None))
    old = jsim_runner.elastic.remesh_restore_brain
    jsim_runner.elastic.remesh_restore_brain = remesh
    try:
        jsim_runner.SimulationRunner._maybe_degrade(
            stand_in, {"subscription_overflow": 0, "request_overflow": 0},
            stats_delta)
    finally:
        jsim_runner.elastic.remesh_restore_brain = old
    return seen["cfg"]


@pytest.mark.parametrize("growth,action", [(4, "grow_subs_cap"),
                                           (0, "dense_fallback")])
def test_degrade_ladder_4rank(tmp_path, growth, action):
    """Persistent subscription overflow first grows the achieved cap, and
    with growth off falls back to the dense layout; the run completes, the
    step down is counted, and the new config is the JAX ladder's."""
    fields = dict(BASE, neurons_per_rank=256, max_synapses=16,
                  rate_exchange="sparse")
    base = chaos.overflow_config(BrainConfig(**fields))
    r = SimulationRunner(
        SimRunnerConfig(str(tmp_path / "ck"), ckpt_every=2,
                        overflow_patience=1, subs_growth_factor=growth,
                        max_degrades=1),
        cfg=base, num_ranks=R, device="cpu")
    assert r.run(4) == "done"
    assert r.sim.stats()["degrade_events"] == 1 and r.degrades == 1
    want = _jax_ladder(JConfig(**dict(fields, subs_cap_factor=0.0001)), R,
                       {"subscription_overflow": 1, "request_overflow": 0},
                       subs_growth_factor=growth)
    got = r.sim.cfg
    assert (got.rate_exchange, got.subs_cap_factor) == \
        (want.rate_exchange, want.subs_cap_factor)
    if action == "grow_subs_cap":
        assert got.rate_exchange == "sparse"
        assert got.subs_cap_factor > base.subs_cap_factor
    else:
        assert got.rate_exchange == "dense"
    # the checkpoints after the step down have the new shapes
    meta = manager.read_manifest(str(tmp_path / "ck"), 4)["metadata"]
    assert meta["rate_exchange"] == got.rate_exchange


# ------------------------------------------------------ four processes
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GLOO_RANK = """
import numpy as np, torch, torch.distributed as tdist
from repro_torch import convert, dist
from repro_torch.configs.msp_brain import BrainConfig
from repro_torch.runtime.sim_runner import SimRunnerConfig, SimulationRunner
from repro_torch.scenarios import library, observables
from repro_torch.sim.api import Simulator
R, rank = {R}, {rank}
tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                         world_size=R, rank=rank)
comm = dist.ProcessGroupComm()
cfg = BrainConfig(**{fields!r})
scn = library.lesion_rewiring()
sim = Simulator.from_config(cfg, scenario=scn, comm=comm, device="cpu")
sim.run(2)
assert sim.save("{ckpt}") == 2
per_rank = sim.stats(reduce=False)["synapses_formed"]
assert per_rank.shape == (R,) and float(per_rank.sum()) == \\
    sim.stats()["synapses_formed"]
nb = len(scn.regions) + 1
rec = observables.init_recorder(2, nb, device="cpu")
_, rec = sim.run(2, recorder=rec)
rows = observables.flush(rec)
# a restore in every process takes the process's own rows
again = Simulator.from_config(cfg, scenario=scn, comm=comm, device="cpu")
assert again.restore("{ckpt}") == 2
again.run(2)
for a, b in zip(convert.state_to_numpy(again.state)["neurons"].values(),
                convert.state_to_numpy(sim.state)["neurons"].values()):
    assert np.array_equal(a, b)
# the runner under the process group: rank 0 writes, every process reads
r = SimulationRunner(SimRunnerConfig("{runner_ckpt}", ckpt_every=1),
                     cfg=cfg, scenario=scn, comm=comm, device="cpu")
assert r.run(2) == "done" and r.sim.probe_health() == 0
st = convert.state_to_numpy(sim.state)
np.savez("{path}", out_edges=st["out_edges"], in_edges=st["in_edges"],
         v=st["neurons"]["v"], calcium=st["neurons"]["calcium"],
         formed=st["stats"]["counters"]["synapses_formed"],
         **{{"rec_" + k: np.asarray(v) for k, v in rows.items()}})
tdist.destroy_process_group()
print("RANK_OK")
"""


def test_process_group_checkpoint_and_recorder_over_gloo(tmp_path):
    """Four gloo processes (``ProcessGroupComm``, one rank a process) run
    two chunks and save, then two chunks with a recorder. The checkpoint
    restores at R=4 on ``LocalComm`` in this process, and two chunks with a
    recorder there equal the writers' continuing: every rank's state and
    every recorder row bitwise. The runner under the process group leaves
    checkpoints that restore here too."""
    fields = dict(BASE, requests_cap_factor=100, **FUSED)
    port = _free_port()
    # one thread a process: four processes share this machine's cores
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ckpt, runner_ckpt = str(tmp_path / "ck"), str(tmp_path / "runner")
    procs = []
    for r in range(R):
        code = _GLOO_RANK.format(R=R, rank=r, port=port, fields=fields,
                                 ckpt=ckpt, runner_ckpt=runner_ckpt,
                                 path=str(tmp_path / f"rank{r}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in out, out
    assert manager.steps_available(ckpt) == [2]
    assert manager.steps_available(runner_ckpt) == [0, 1, 2]

    cfg = BrainConfig(**fields)
    scn = library.lesion_rewiring()
    sim = Simulator.from_config(cfg, scenario=scn, num_ranks=R, device="cpu")
    assert sim.restore(ckpt) == 2
    rec = observables.init_recorder(2, len(scn.regions) + 1, device="cpu")
    _, rec = sim.run(2, recorder=rec)
    rows = observables.flush(rec)
    for r, st in enumerate(sim.rank_states):
        got = np.load(tmp_path / f"rank{r}.npz")
        for f in ("out_edges", "in_edges"):
            np.testing.assert_array_equal(got[f], getattr(st, f).numpy())
        for f in ("v", "calcium"):
            np.testing.assert_array_equal(got[f],
                                          getattr(st.neurons, f).numpy())
        np.testing.assert_array_equal(got["formed"],
                                      st.stats.counters["synapses_formed"])
        for k, v in rows.items():
            np.testing.assert_array_equal(got["rec_" + k], np.asarray(v),
                                          err_msg=k)
    runner_sim = Simulator.from_config(cfg, scenario=scn, num_ranks=R,
                                       device="cpu")
    assert runner_sim.restore(runner_ckpt) == 2
    ref = Simulator.from_config(cfg, scenario=scn, num_ranks=R, device="cpu")
    ref.run(2)
    for f in ("out_edges", "in_edges", "positions"):
        assert torch.equal(getattr(ref.state, f),
                           getattr(runner_sim.state, f)), f
