"""The brain's traffic: whole episodes of the MSP simulation back to back.

An episode is ``Simulator.init()`` then ``Simulator.run(chunks)`` (with a
per-region recorder when the mix has a scenario, as ``run_scenario``
does), so every episode is the same work whatever the speed. Set-up
builds the simulator and runs one episode, which loads every kernel and
warms every shape. The window runs episodes until ``seconds`` have passed
and ends with the episode it is in; ``chunk_ms`` is the window's wall time
over the chunks it completed.

``correct``: the window's first episode keeps copies of the state at its
start, after chunk 0, and before and after chunk ``k`` (the mix's
``check_chunk``, or drawn from the seed in 1..chunks-1). Once the window
has closed and the simulator is freed, the plain reference
(``portbench/reference/msp.py``) draws the initial state from the seed and
runs chunk 0 from it, and runs chunk k from the program's state before it
(the reference follows the program from its own state there: chunks 1 to
k-1 are checked by other seeds' draws of k). Each comparison counts the
elements whose bits differ over the whole state; with a scenario, the
recorder's row of chunk k too. The limit of each count is 0.

Traced: the mix's ``trace_episodes`` episodes, chunk by chunk, under the
profiler; the in-edges each chunk's K1 reads are counted on the device,
and chunk ``k2_sample_chunk`` of the first runs inside a
``portbench.sample`` range, whose K2 work the reference's search replays.
"""
from __future__ import annotations

import contextlib
import gc
import random
import time

import torch
from torch.profiler import record_function

from portbench.bench import trace as trace_mod
from portbench.bench import work
from portbench.bench.harness import Outcome
from portbench.reference import msp

NEURON_FIELDS = ("v", "u", "calcium", "ax_elements", "de_elements",
                 "spiked", "spike_count", "rate", "is_excitatory")
LOWERINGS = ("activity_impl", "connectivity_impl", "tree_impl",
             "apply_impl")
RECORD_FIELDS = ("calcium", "rate", "synapses", "alive", "connectome",
                 "rate_hist")


def reference_config(config: dict, seed: int) -> dict:
    """The configuration file as the reference reads it."""
    cfg = {k: v for k, v in config.items() if not isinstance(v, (dict, list))}
    cfg["neurons_per_rank"] = config["neurons"]
    cfg["seed"] = seed
    return cfg


def program_config(config: dict, seed: int):
    """The program's ``BrainConfig`` for the configuration file."""
    import dataclasses
    from repro_torch.configs.msp_brain import BrainConfig
    ref = reference_config(config, seed)
    kw = {}
    for f in dataclasses.fields(BrainConfig):
        if f.name in LOWERINGS:
            kw[f.name] = config["lowerings"]
        elif f.name in ref and f.name != "name":
            kw[f.name] = ref[f.name]
    return BrainConfig(**kw)


def program_scenario(sc):
    """The program's ``Scenario`` for the mix's scenario dict."""
    if sc is None:
        return None
    from repro_torch.scenarios.protocol import (Lesion, Recover, Scenario,
                                                Stimulate)
    from repro_torch.scenarios.regions import Region
    make = {"lesion": lambda e: Lesion(e["region"], e["t"]),
            "recover": lambda e: Recover(e["region"], e["t"]),
            "stimulate": lambda e: Stimulate(e["region"], e["amplitude"],
                                             e["t0"], e["t1"])}
    return Scenario(
        name=sc["name"],
        regions=tuple(Region(r["name"], lo=tuple(r["lo"]), hi=tuple(r["hi"]))
                      for r in sc["regions"]),
        events=tuple(make[e["kind"]](e) for e in sc["events"]))


def snapshot(sim) -> dict:
    st = sim.state
    out = {k: getattr(st.neurons, k).clone() for k in NEURON_FIELDS}
    out.update(out_edges=st.out_edges.clone(), in_edges=st.in_edges.clone(),
               positions=st.positions.clone(),
               rates_table=st.rates_table.clone(), chunk=st.chunk)
    return out


class Episodes:
    """Runs episodes of one simulator; ``stops`` (chunk counts) take a
    snapshot of the state after that many chunks of the episode."""

    def __init__(self, sim, chunks: int, regions: int, device):
        self.sim, self.chunks, self.nb, self.device = sim, chunks, regions, \
            device

    def run(self, stops=(), snaps=None, per_chunk=False, hook=None,
            sample=None):
        """One episode; with ``per_chunk`` a chunk a call, ``hook(done)``
        before each and chunk ``sample`` inside a ``portbench.sample``
        range."""
        from repro_torch.scenarios import observables
        sim = self.sim
        sim.init()
        rec = observables.init_recorder(self.chunks, self.nb,
                                        device=self.device) \
            if self.nb else None
        done = 0
        for stop in sorted(set(stops) | {self.chunks}):
            while done < stop:
                k = 1 if per_chunk else stop - done
                if hook is not None:
                    hook(done)
                with record_function("portbench.sample") \
                        if per_chunk and done == sample \
                        else contextlib.nullcontext():
                    if rec is None:
                        sim.run(k)
                    else:
                        _, rec = sim.run(k, recorder=rec)
                done += k
            if stop in stops:
                snaps[stop] = snapshot(sim)
        return rec


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(r) -> Outcome:
    from repro_torch.kernels import _build
    from repro_torch.sim.api import Simulator
    dev = r.device
    t = r.traffic
    chunks = t["chunks_per_episode"]
    scen = t["scenario"]
    seed = r.seed
    cfg = program_config(r.config, seed)
    rcfg = reference_config(r.config, seed)
    k = t["check_chunk"] if t.get("check_chunk") is not None else \
        random.Random(seed).randrange(1, chunks)
    if dev.type == "cuda":
        _build.library()
    sim = Simulator.from_config(cfg, scenario=program_scenario(scen),
                                device=dev)
    eps = Episodes(sim, chunks, len(scen["regions"]) + 1 if scen else 0, dev)
    eps.run()                                        # warm-up
    _sync(dev)
    r.setup_done()

    snaps, rec0 = {}, None
    stops = (0, 1, k, k + 1)
    traced, valid = {}, []
    units = 0
    if r.trace:
        sample = t["k2_sample_chunk"]

        def hook(done):
            valid.append((sim.state.in_edges >= 0).sum())
            if done == sample and "sample" not in snaps:
                snaps["sample"] = snapshot(sim)

        with trace_mod.profiled(traced):
            with record_function(trace_mod.WINDOW):
                for e in range(t["trace_episodes"]):
                    if e == 0:
                        rec0 = eps.run(stops, snaps, per_chunk=True,
                                       hook=hook, sample=sample)
                    else:
                        eps.run(per_chunk=True, hook=hook)
                    units += chunks
        elapsed = None
    else:
        t0 = time.perf_counter()
        while True:
            if units == 0:
                rec0 = eps.run(stops, snaps)
            else:
                eps.run()
            units += chunks
            _sync(dev)
            if time.perf_counter() - t0 >= r.seconds:
                break
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    del sim, eps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(snaps, rec0, k, rcfg, scen, dev)
    if getattr(r, "control", False):
        r.control_checks = control(snaps, k, rcfg, scen)
    out = Outcome(attempted=units, failed=0,
                  end_to_end={} if elapsed is None else
                  {"chunk_ms": elapsed * 1e3 / units},
                  checks=checks, memory_peak_bytes=peak, units=units)
    if r.trace:
        out.trace = traced["trace"]
        out.work = traced_work(torch.stack(valid).cpu().tolist(),
                               snaps["sample"], rcfg, scen)
    return out


def compare(snaps, rec, k, rcfg, scen, dev) -> dict:
    """The counts of differing elements, each with its limit 0."""
    init = msp.init_state(rcfg, dev, scen)
    checks = {"init_mismatch": sum(msp.state_mismatches(snaps[0], init)
                                   .values())}
    ref0 = msp.chunk(init, rcfg, scen)
    del init
    checks["chunk0_mismatch"] = sum(msp.state_mismatches(snaps[1], ref0)
                                    .values())
    del ref0
    ref_k = msp.chunk(snaps[k], rcfg, scen)
    checks[f"chunk{k}_mismatch"] = sum(
        msp.state_mismatches(snaps[k + 1], ref_k).values())
    if rec is not None:
        row = msp.record_row(ref_k, rcfg, scen)
        checks[f"record{k}_mismatch"] = sum(
            msp.mismatches(getattr(rec, f)[k], row[f]) for f in RECORD_FIELDS)
    return {name: (v, 0) for name, v in checks.items()}


def control(snaps, k, rcfg, scen) -> dict:
    """The control's counts: the reference in bfloat16 put in the
    program's place, against the reference."""
    want = msp.chunk(snaps[k], rcfg, scen)
    got = msp.chunk(snaps[k], rcfg, scen, precision="bfloat16")
    return {f"chunk{k}_mismatch": (sum(msp.state_mismatches(got, want)
                                       .values()), 0)}


def traced_work(valid, sample_state, rcfg, scen) -> dict:
    """K1's work over the traced chunks and K2's at the sampled chunk."""
    n, s = rcfg["neurons_per_rank"], rcfg["max_synapses"]
    steps = rcfg["rate_period"]
    lesions = bool(scen and any(e["kind"] == "lesion"
                                for e in scen["events"]))
    k1 = {"bytes": 0, "int_ops": 0, "fp_ops": 0}
    for v in valid:
        w = work.k1_window(n, s, steps, int(v), lesions)
        for key in k1:
            k1[key] += w[key]
    p = msp.search_inputs(sample_state, rcfg, scen)
    args = (p["members"], p["positions"], p["vac_d_pos"], p["r_pos"],
            p["start"], p["src"], p["r_valid"])
    w2 = work.k2_work(p["tree"], p["members"], p["positions"],
                      p["vac_d_pos"], p["r_pos"], p["start"], p["src"], rcfg,
                      sample_state["chunk"])
    k2 = work.k2_bound_inputs(
        w2, sum(a.numel() * a.element_size() for a in args), p["widths"],
        p["r_pos"].shape[0])
    return {"k1": k1, "k2": k2, "k2_search": w2}
