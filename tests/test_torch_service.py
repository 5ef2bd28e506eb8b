"""The port's multi-tenant service (``repro_torch.service``) against the JAX
package's (``repro.service``) at one rank, on the JAX service tests' SMALL
config with the reference lowerings.

Every script of ``tests/test_service.py`` runs through both packages, after
both ``RequestHandle._next_id`` counters are set to 0 (the retry jitter
hashes the handle's id): submit, queue and complete; the overload shed; the
incompatible budget; the deadline in a slot and in the queue; one NaN
poison retried with backoff; a persistent poison that spends its retries;
the stall watchdog; the degradation ladder; B=4 with slot 1 poisoned; the
heartbeat. One JAX ``SlotBatch`` a width serves every script, as in
``tests/test_service.py``.

Tolerances: statuses, chunks done, retries, backoff records, ``stats()``,
events, the tenants' counters and the heartbeat are equal to JAX's; the
tick, chunk and live-edge columns of the observations are equal, rate and
calcium within ``FLOAT_TOL`` x max(|x|, 1) (``_torch_ranks``); a final
state's integer leaves are equal to the JAX lane's and its float leaves
within the same tolerance. Inside the port: every tenant's final state is
bitwise its solo ``Simulator`` run, co-tenant observations bitwise those of
an unpoisoned run.
"""
import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as tr
from repro import service as jservice
from repro.checkpoint import manager as jmanager
from repro.configs.msp_brain import BrainConfig as JConfig
from repro.runtime import chaos as jchaos
from repro.service import types as jtypes
from repro.sim.api import Simulator as JSim
from repro_torch import service as tservice
from repro_torch import telemetry
from repro_torch.checkpoint import manager
from repro_torch.configs.msp_brain import BrainConfig as TConfig
from repro_torch.runtime import chaos as tchaos
from repro_torch.service import types as ttypes
from repro_torch.sim.api import Simulator

SMALL = dict(neurons_per_rank=32, local_levels=3, frontier_cap=32,
             max_synapses=8, rate_period=10, requests_cap_factor=100,
             subs_cap_factor=100)
JAX = types.SimpleNamespace(svc=jservice, chaos=jchaos, types=jtypes)
PORT = types.SimpleNamespace(svc=tservice, chaos=tchaos, types=ttypes)


# --------------------------------------------------------------- scripts
# Each script drives one service through ``P`` (JAX or PORT) and returns
# (service, {name: handle}, extra); ``make(service_cfg)`` builds the
# package's service on its shared batch of that width.
def s_submit_queue_complete(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2, queue_cap=4))
    hs = {f"s{s}": svc.submit(P.svc.SimRequest(seed=s, chunks=c))
          for s, c in ((3, 3), (11, 2), (5, 3))}
    extra = {"status_at_submit": [h.status.value for h in hs.values()]}
    svc.run_until_idle()
    return svc, hs, extra


def s_overload_shed(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2, queue_cap=1))
    hs = {f"s{s}": svc.submit(P.svc.SimRequest(seed=s, chunks=2))
          for s in (1, 2, 3)}
    with pytest.raises(P.svc.ServiceOverloaded) as ei:
        svc.submit(P.svc.SimRequest(seed=4, chunks=2))
    extra = {"shed": (ei.value.queue_depth, ei.value.queue_cap,
                      len(svc.queue))}
    svc.run_until_idle()
    return svc, hs, extra


def s_incompatible_budget(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2))
    bad = P.chaos.overflow_slot_config(
        P.svc.SimRequest(seed=1, chunks=2),
        svc.service_cfg.max_chunks_per_request)
    for req in (bad, P.svc.SimRequest(seed=1, chunks=0)):
        with pytest.raises(P.svc.IncompatibleRequest):
            svc.submit(req)
    return svc, {}, {"queue": len(svc.queue)}


def s_deadline_in_slot(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2, queue_cap=4))
    hs = {"doomed": svc.submit(P.svc.SimRequest(seed=7, chunks=10_000,
                                                deadline_s=0.0)),
          "ok": svc.submit(P.svc.SimRequest(seed=8, chunks=2))}
    svc.run_until_idle()
    return svc, hs, {}


def s_deadline_in_queue(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2, queue_cap=4))
    hs = {f"s{s}": svc.submit(P.svc.SimRequest(seed=s, chunks=2))
          for s in (1, 2)}
    hs["queued"] = svc.submit(P.svc.SimRequest(seed=3, chunks=2,
                                               deadline_s=0.0))
    svc.run_until_idle()
    return svc, hs, {}


def s_poison_retried(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2))
    svc.chaos_hooks.append(P.chaos.poison_slot_nan(0, after_chunk=2))
    hs = {"poisoned": svc.submit(P.svc.SimRequest(seed=9, chunks=4,
                                                  max_retries=2))}
    svc.run_until_idle()
    return svc, hs, {}


def s_poison_persistent(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2))

    def always_poison(service):   # re-poison after every step
        P.chaos.poison_slot_nan(0, after_chunk=0)(service)

    svc.chaos_hooks.append(always_poison)
    hs = {"doomed": svc.submit(P.svc.SimRequest(seed=4, chunks=4,
                                                max_retries=1))}
    svc.run_until_idle(max_ticks=50)
    return svc, hs, {}


def s_stall_watchdog(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2, stall_patience=2))
    svc.chaos_hooks.append(P.chaos.stall_slot(0, ticks=50))
    hs = {"stuck": svc.submit(P.svc.SimRequest(seed=6, chunks=30,
                                               max_retries=0)),
          "ok": svc.submit(P.svc.SimRequest(seed=2, chunks=3))}
    svc.run_until_idle(max_ticks=30)
    return svc, hs, {}


def s_degradation(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=2, queue_cap=1,
                                   chunks_per_tick=4, min_chunks_per_tick=1,
                                   overload_patience=1))
    hs = {"low": svc.submit(P.svc.SimRequest(seed=1, chunks=200,
                                             priority=0)),
          "high": svc.submit(P.svc.SimRequest(seed=2, chunks=8,
                                              priority=5)),
          "waiting": svc.submit(P.svc.SimRequest(seed=3, chunks=2))}
    svc.run_until_idle(max_ticks=60)
    return svc, hs, {"chunks_per_tick": svc.chunks_per_tick}


SEEDS4 = (3, 11, 5, 7)


def s_b4_poisoned(P, make, tmp):
    svc = make(P.svc.ServiceConfig(num_slots=4))
    svc.chaos_hooks.append(
        P.chaos.poison_slot_nan(1, field="calcium", after_chunk=1))
    hs = {f"s{s}": svc.submit(P.svc.SimRequest(seed=s, chunks=3))
          for s in SEEDS4}
    svc.run_until_idle()
    return svc, hs, {}


def s_heartbeat(P, make, tmp):
    hb = os.path.join(tmp, "hb.json")
    svc = make(P.svc.ServiceConfig(num_slots=2, heartbeat_path=hb))
    hs = {"s1": svc.submit(P.svc.SimRequest(seed=1, chunks=2))}
    svc.run_until_idle()
    with open(hb) as f:
        d = json.load(f)
    assert d["tick"] == svc.tick_count and "t" in d
    del d["t"]
    return svc, hs, {"heartbeat": d}


SCRIPTS = {f.__name__[2:]: f for f in (
    s_submit_queue_complete, s_overload_shed, s_incompatible_budget,
    s_deadline_in_slot, s_deadline_in_queue, s_poison_retried,
    s_poison_persistent, s_stall_watchdog, s_degradation, s_b4_poisoned,
    s_heartbeat)}


@pytest.fixture(scope="module")
def jax_batches():
    cfg = JConfig(**SMALL)
    return cfg, {b: jservice.SlotBatch(cfg, b) for b in (2, 4)}


@pytest.fixture(scope="module")
def port_batches():
    cfg = TConfig(**SMALL)
    return cfg, {b: tservice.SlotBatch(cfg, b, device="cpu")
                 for b in (2, 4)}


@pytest.fixture(scope="module")
def runs(jax_batches, port_batches, tmp_path_factory):
    """{script: {"jax": (svc, handles, extra), "port": ..., "port_spans":
    the port's spans of that run}}, each script run once a package."""
    cache = {}

    def get(name):
        if name not in cache:
            out = {}
            for key, P, (cfg, batches) in (("jax", JAX, jax_batches),
                                           ("port", PORT, port_batches)):
                def make(sc, P=P, cfg=cfg, batches=batches):
                    return P.svc.SimulationService(
                        cfg, sc, batch=batches[sc.num_slots])
                P.types.RequestHandle._next_id = 0
                telemetry.clear()
                tmp = str(tmp_path_factory.mktemp(f"{name}_{key}"))
                out[key] = SCRIPTS[name](P, make, tmp)
                if key == "port":
                    out["port_spans"] = telemetry.spans()
            cache[name] = out
        return cache[name]

    return get


def _assert_close(got, want, what):
    """Integer leaves equal, float leaves within FLOAT_TOL x max(|x|, 1)
    (NaN where JAX has NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        assert np.array_equal(np.isnan(got), np.isnan(want)), what
        ok = ~np.isnan(want)
        err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1.0)
        assert err.size == 0 or err.max() <= tr.FLOAT_TOL, (what, err.max())
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _host(tree):
    """{key: numpy copy} of a port tree (the chunk as an int32 scalar)."""
    return {k: np.array(x.detach().cpu().numpy()
                        if isinstance(x, torch.Tensor) else x,
                        np.int32 if isinstance(x, int) else None)
            for k, x in manager._flatten(tree)}


def _backoffs(h):
    return [dataclasses.astuple(b) for b in h.backoffs]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_service_script_matches_jax(runs, name):
    """Statuses, chunks, retries, backoffs, stats(), events, counters,
    observations and final states of the port's service equal the JAX
    service's on the same script."""
    r = runs(name)
    (jsvc, jhs, jextra), (tsvc, ths, textra) = r["jax"], r["port"]
    assert textra == jextra
    assert tsvc.stats() == jsvc.stats()
    assert tsvc.events == jsvc.events
    assert list(ths) == list(jhs)
    for k in jhs:
        jh, th = jhs[k], ths[k]
        assert (th.id, th.status.value, th.chunks_done, th.retries,
                _backoffs(th)) == (jh.id, jh.status.value, jh.chunks_done,
                                   jh.retries, _backoffs(jh)), k
        jr, tres = jh.result, th.result
        assert (tres.status.value, tres.chunks_done, tres.retries,
                _backoffs(tres)) == (jr.status.value, jr.chunks_done,
                                     jr.retries, _backoffs(jr)), k
        assert tres.counters == jr.counters, k
        jo, to = np.asarray(jr.observations), np.asarray(tres.observations)
        assert to.shape == jo.shape, k
        np.testing.assert_array_equal(to[:, [0, 1, 4]], jo[:, [0, 1, 4]])
        _assert_close(to[:, 2:4], jo[:, 2:4], f"{k} rate, calcium")
        assert (tres.final_state is None) == (jr.final_state is None), k
        if jr.final_state is not None:
            got = _host(tres.final_state)
            want = jmanager._flatten(jax.device_get(jr.final_state))[0]
            assert list(got) == [key for key, _ in want]
            for key, leaf in want:
                _assert_close(got[key], leaf, f"{k} {key}")


@pytest.mark.parametrize("name", ["submit_queue_complete", "poison_retried",
                                  "b4_poisoned", "degradation"])
def test_tenants_bitwise_their_solo_runs(runs, name):
    """Inside the port, every DONE tenant's final state is bitwise a solo
    Simulator run of its seed (the poisoned one after its rollback too)."""
    _, hs, _ = runs(name)["port"]
    done = [h for h in hs.values()
            if h.result.status is ttypes.RequestStatus.DONE]
    assert done
    for h in done:
        sim = Simulator(dataclasses.replace(TConfig(**SMALL),
                                            seed=h.request.seed),
                        device="cpu")
        sim.run(h.request.chunks)
        got, want = _host(h.result.final_state), _host(sim.state)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cotenant_observations_bitwise_an_unpoisoned_run(runs,
                                                         port_batches):
    """B=4, slot 1 poisoned: slot 1 quarantines and rolls back, and the
    co-tenants' observation rows are bitwise an unpoisoned run's."""
    tsvc, hs, _ = runs("b4_poisoned")["port"]
    assert tsvc.stats()["quarantines"] >= 1
    assert tsvc.stats()["slot_rollbacks"] >= 1
    assert hs["s11"].retries >= 1
    cfg, batches = port_batches
    clean = tservice.SimulationService(cfg, tservice.ServiceConfig(
        num_slots=4), batch=batches[4])
    ch = [clean.submit(tservice.SimRequest(seed=s, chunks=3))
          for s in SEEDS4]
    clean.run_until_idle()
    for i, s in enumerate(SEEDS4):
        if s != 11:
            np.testing.assert_array_equal(hs[f"s{s}"].observations,
                                          ch[i].observations)


def test_backoff_and_rollback_spans(runs):
    """The poison script records one ``service.backoff`` span (attempt 1)
    and a ``service.rollback`` span, as the JAX service does."""
    spans = runs("poison_retried")["port_spans"]
    backoff = [s for s in spans if s.name == "service.backoff"]
    assert len(backoff) == 1 and backoff[0].attrs["attempt"] == 1
    assert backoff[0].attrs["reason"] == "health"
    assert [s for s in spans if s.name == "service.rollback"]
    names = {s.name for s in spans}
    assert {"service.construct", "service.admit", "service.tick",
            "service.run_until_idle"} <= names


def test_slot_checkpoint_restores_through_jax(tmp_path, port_batches):
    """``ckpt_dir`` writes ``slot{b}/step_<chunk>`` in the JAX layout: the
    JAX manager restores it, bitwise a solo port run at that chunk."""
    cfg, batches = port_batches
    ck = str(tmp_path / "ck")
    svc = tservice.SimulationService(cfg, tservice.ServiceConfig(
        num_slots=2, ckpt_dir=ck), batch=batches[2])
    h = svc.submit(tservice.SimRequest(seed=5, chunks=3, tag="t5"))
    svc.run_until_idle()
    assert h.result.status is ttypes.RequestStatus.DONE
    steps = manager.steps_available(os.path.join(ck, "slot0"))
    assert steps == [1, 2]
    jsim = JSim.from_config(dataclasses.replace(JConfig(**SMALL), seed=5))
    tree, manifest = jmanager.restore(os.path.join(ck, "slot0"), 2,
                                      jax.eval_shape(jsim.init_fn))
    assert manifest["metadata"]["seed"] == 5
    assert manifest["metadata"]["tag"] == "t5"
    solo = Simulator(dataclasses.replace(cfg, seed=5), device="cpu")
    solo.run(2)
    want = _host(solo.state)
    got = jmanager._flatten(tree)[0]
    assert [k for k, _ in got] == list(want)
    for k, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[k], err_msg=k)


def test_config_errors_and_a_fused_template(port_batches):
    """No slot is a typed config error; a shared batch of another width
    too; a template with all five fused lowerings is served (on the CPU
    its wrappers run the plain versions), bitwise its solo fused run."""
    cfg, batches = port_batches
    with pytest.raises(tservice.ServiceConfigError):
        tservice.SlotBatch(cfg, 0, device="cpu")
    with pytest.raises(tservice.ServiceConfigError):
        tservice.SimulationService(cfg, tservice.ServiceConfig(num_slots=4),
                                   batch=batches[2])
    fused = dataclasses.replace(cfg, **tr.FUSED)
    svc = tservice.SimulationService(fused, tservice.ServiceConfig(
        num_slots=2), device="cpu")
    h = svc.submit(tservice.SimRequest(seed=3, chunks=2))
    svc.run_until_idle()
    assert h.result.status is ttypes.RequestStatus.DONE
    solo = Simulator(dataclasses.replace(fused, seed=3), device="cpu")
    solo.run(2)
    got, want = _host(h.result.final_state), _host(solo.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lanes_share_no_storage(port_batches):
    """``place`` and ``extract`` copy every tensor leaf: a snapshot is not
    changed by its lane's next chunk (whose metrics add in place), and
    ``init_all`` equals ``init_lane`` a seed."""
    cfg, batches = port_batches
    batch = batches[2]
    state = batch.init_all([3, 4])
    for b, s in enumerate((3, 4)):
        want = _host(batch.init_lane(s)[0])
        got = _host(state[b][0])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    snap = batch.extract(state, 0)
    ptrs = {x.data_ptr() for _, x in manager._flatten(state[0][0])
            if isinstance(x, torch.Tensor)}
    assert not ptrs & {x.data_ptr() for _, x in manager._flatten(snap[0])
                       if isinstance(x, torch.Tensor)}
    before = _host(snap[0])
    state = batch.place(state, snap, 1)
    state = batch.step(state, np.array([3, 3], np.int32), [0, 1])
    after = _host(snap[0])
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    # slot 1 ran slot 0's snapshot under slot 0's seed: the same chunk
    a, b = _host(state[0][0]), _host(state[1][0])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
