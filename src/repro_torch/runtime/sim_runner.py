"""Fault-tolerant simulation runner: ``SimulationRunner`` wraps
``Simulator.run`` with the run's whole lifecycle. The port's copy of the JAX
package's ``repro/runtime/sim_runner.py``.

Mechanisms:
  * periodic async atomic keep-k checkpoints (``AsyncCheckpointer``) at
    chunk boundaries, and resume from the latest: every draw is keyed by
    the seed, the chunk counter and the per-step hash, so kill-and-resume
    at any chunk boundary is bitwise an uninterrupted run;
  * the health verdict: every chunk refreshes the health gauges
    (``sim.phases.health_verdict``); the runner polls the global
    ``health_flags`` each checkpoint interval and also *probes* the state
    it is about to save, so every checkpoint on disk is a healthy one and
    a rollback target is never itself poisoned;
  * bounded rollback: on a bad verdict, restore the newest checkpoint that
    passes checksum and structure checks (walking past corrupt steps) and
    run again; more than ``max_rollbacks`` raises;
  * graceful degradation: ``subscription_overflow`` / ``request_overflow``
    over ``overflow_patience`` intervals in a row rebuilds the Simulator
    through the elastic restore with a grown ``subs_cap_factor`` (then
    ``rate_exchange='dense'``), or a grown ``requests_cap_factor``; each
    step down is a ``repro.runner.degrade`` range and a ``degrade_events``
    count;
  * preemption: ``preempt()`` (safe in a signal handler) makes the loop
    write a final checkpoint and return ``"preempted"`` at the next chunk
    boundary;
  * an atomic heartbeat JSON each interval (``fault_tolerance
    .write_heartbeat``) for an external watchdog, with a self-check of the
    previous beat's age (``fault_tolerance.read_heartbeat``) counted as
    ``heartbeat_stale``;
  * elastic resume: a fresh runner whose cfg disagrees with the
    checkpoint's metadata (fewer ranks, another exchange layout, other
    caps after a degrade) restores through ``elastic.remesh_restore_brain``
    instead of directly.

The lifecycle counters (``checkpoint_saves`` / ``checkpoint_restores`` /
``rollbacks`` / ``restarts`` / ``degrade_events`` / ``heartbeat_stale``)
live on the Simulator and show in ``Simulator.stats()``. Each step of the
lifecycle runs under a ``repro.runner.<name>`` profiler range. Under a
``dist.ProcessGroupComm`` every process runs the same loop: the collectives
(stats, health, probe, the gathered state) in step, rank 0 writing the
checkpoints and the heartbeat, and a barrier before any checkpoint is read.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch import telemetry
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import AsyncCheckpointer
from repro_torch.connectome import routing
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import read_heartbeat, write_heartbeat


@dataclasses.dataclass
class SimRunnerConfig:
    """Runner knobs. ``ckpt_every`` is in chunks (one chunk = Delta
    activity steps + one connectivity update); a smaller value narrows the
    window run again after a fault, at the cost of checkpoint I/O."""
    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3
    max_rollbacks: int = 3
    heartbeat_path: Optional[str] = None
    # previous-beat age (s) beyond which the runner counts heartbeat_stale
    # before publishing a fresh beat: the in-band echo of the external
    # watchdog's verdict
    heartbeat_max_age_s: Optional[float] = None
    # degradation ladder
    max_degrades: int = 2
    overflow_patience: int = 2     # overflowing intervals in a row
    # achieved-cap multiplier a step; 0 disables growth, so the first
    # subscription-overflow step falls straight back to dense
    subs_growth_factor: int = 4
    requests_growth_factor: int = 4


# metadata keys that must agree for a direct (non-elastic) resume
_SHAPE_KEYS = ("num_ranks", "neurons_per_rank", "rate_exchange",
               "subs_cap_factor", "requests_cap_factor")


class SimulationRunner:
    """Drive a Simulator to a target chunk count, surviving preemption,
    state corruption, checkpoint corruption and exhausted exchange caps.

    >>> runner = SimulationRunner(SimRunnerConfig(ckpt_dir), cfg)
    >>> runner.run(100)      # resumes from ckpt_dir if checkpoints exist
    'done'

    ``num_ranks``, ``device`` and ``comm`` go to the ``Simulator`` (the
    card unless ``device`` names another)."""

    def __init__(self, run_cfg: SimRunnerConfig, cfg=None, sim=None,
                 scenario=None, num_ranks: int = 1, device=None, comm=None,
                 resume: bool = True):
        from repro_torch.sim.api import Simulator
        if (cfg is None) == (sim is None):
            raise ValueError("pass exactly one of cfg= or sim=")
        self.cfg = run_cfg
        self.scenario = scenario if sim is None else sim.scenario
        self.sim = sim if sim is not None else Simulator(
            cfg, scenario=scenario, num_ranks=num_ranks, device=device,
            comm=comm)
        self.ckpt = AsyncCheckpointer(run_cfg.ckpt_dir, keep=run_cfg.keep)
        self.preempted = False
        self.degrades = 0
        self._overflow_strikes = 0
        self._last_saved_chunk: Optional[int] = None
        # chaos hooks: callables(runner) invoked after every segment,
        # BEFORE the health poll and checkpoint (runtime.chaos)
        self.chaos_hooks: List[Callable] = []
        if resume:
            self.try_resume()

    def _sync(self):
        """The pending write finished and, under a process group, seen by
        every process (before any checkpoint is read)."""
        self.ckpt.wait()
        self.sim.barrier()

    def _elastic(self, cfg, step):
        """A Simulator for ``cfg`` at this runner's ranks, device and comm,
        restored from ``step`` through the elastic path."""
        return elastic.remesh_restore_brain(
            self.cfg.ckpt_dir, cfg, num_ranks=self.sim.num_ranks, step=step,
            scenario=self.scenario, device=self.sim.device,
            comm=self.sim.comm)

    # ---------------------------------------------------------- resume
    def _latest_valid_manifest(self):
        self._sync()
        for step in reversed(manager.steps_available(self.cfg.ckpt_dir)):
            try:
                _, manifest = manager.load_arrays(self.cfg.ckpt_dir, step)
            except manager.CorruptCheckpointError:
                continue
            return step, manifest
        return None, None

    def try_resume(self) -> bool:
        """Adopt the newest valid checkpoint, if any. A checkpoint of the
        runner's shapes restores directly; any other (another rank count,
        exchange layout or caps) goes through the elastic restore, which
        takes the new ranks' rows and rebuilds the subscription registry."""
        step, manifest = self._latest_valid_manifest()
        if step is None:
            return False
        meta = manifest.get("metadata", {})
        mine = self.sim.ckpt_metadata()
        direct = all(meta.get(k) == mine[k] for k in _SHAPE_KEYS)
        with telemetry.span("runner.restore", step=step,
                            elastic=not direct):
            if direct:
                self.sim.restore(self.cfg.ckpt_dir, step)
                self.sim.lifecycle.update(
                    {k: int(v)
                     for k, v in meta.get("lifecycle", {}).items()})
                self.sim.lifecycle["checkpoint_restores"] += 1
            else:
                self.sim, step = self._elastic(self.sim.cfg, step)
        self.sim.lifecycle["restarts"] += 1
        self._last_saved_chunk = step
        return True

    # ------------------------------------------------------- checkpoint
    def _checkpoint(self) -> bool:
        """Probe the current state and, if healthy, save it (async,
        atomic, keep-k). Returns False, the save refused, when the probe
        flags corruption, so a poisoned state never becomes a rollback
        target."""
        if self.sim.probe_health() != 0:
            return False
        step = self.sim.chunk
        with telemetry.span("runner.checkpoint_save", step=step):
            tree = self.sim.global_state()
            if self.sim.is_writer:
                self.ckpt.save(step, tree,
                               metadata=dict(self.sim.ckpt_metadata(),
                                             chunk=step))
        self.sim.lifecycle["checkpoint_saves"] += 1
        self._last_saved_chunk = step
        return True

    def _rollback(self):
        """Restore the newest checkpoint that verifies AND matches the
        current state's keys, shapes and dtypes (after a degrade, the
        shapes before it are skipped), bounded by ``max_rollbacks``."""
        self.sim.lifecycle["rollbacks"] += 1
        if self.sim.lifecycle["rollbacks"] > self.cfg.max_rollbacks:
            raise RuntimeError(
                f"giving up after {self.cfg.max_rollbacks} rollbacks")
        self._sync()
        with telemetry.span("runner.rollback"):
            for step in reversed(
                    manager.steps_available(self.cfg.ckpt_dir)):
                try:
                    self.sim.restore(self.cfg.ckpt_dir, step)
                except (manager.CorruptCheckpointError, KeyError,
                        ValueError):
                    continue
                if self.sim.probe_health() == 0:
                    return step
        raise RuntimeError("no healthy checkpoint to roll back to")

    # ---------------------------------------------------------- degrade
    def _maybe_degrade(self, stats_before: dict, stats_after: dict):
        """Step down when the exchange keeps overflowing: every dropped
        subscription or request in an interval is a strike; after
        ``overflow_patience`` strikes in a row, rebuild the Simulator one
        rung down the ladder (grown sparse caps -> dense fallback, or grown
        request caps) through the elastic restore at the same rank
        count."""
        keys = ("subscription_overflow", "request_overflow")
        delta = {k: stats_after[k] - stats_before[k] for k in keys}
        if not any(v > 0 for v in delta.values()):
            self._overflow_strikes = 0
            return
        self._overflow_strikes += 1
        if self._overflow_strikes < self.cfg.overflow_patience:
            return
        self._overflow_strikes = 0
        if self.degrades >= self.cfg.max_degrades:
            return
        cfg = self.sim.cfg
        if cfg.rate_exchange == "sparse" and \
                delta["subscription_overflow"] > 0:
            # grow the ACHIEVED cap (cap_subs floors and ceils the factor),
            # not the raw factor: the smallest integer factor whose cap is
            # >= growth x the current cap
            cap_old = routing.cap_subs(cfg, self.sim.num_ranks)
            denom = routing.subs_base(cfg, self.sim.num_ranks)
            new_factor = -(-cap_old * self.cfg.subs_growth_factor
                           // denom)
            new_cfg = dataclasses.replace(cfg,
                                          subs_cap_factor=int(new_factor))
            if routing.cap_subs(new_cfg, self.sim.num_ranks) <= cap_old:
                # the cap is at its ceiling (or growth is off): the last
                # rung, the dense layout, never overflows
                new_cfg = dataclasses.replace(cfg, rate_exchange="dense")
                action = "dense_fallback"
            else:
                action = "grow_subs_cap"
        else:
            new_cfg = dataclasses.replace(
                cfg, requests_cap_factor=(cfg.requests_cap_factor
                                          * self.cfg.requests_growth_factor))
            action = "grow_requests_cap"
        # checkpoint the (healthy) current state so the elastic path has a
        # boundary to restore from, then swap in the rebuilt Simulator and
        # checkpoint again under the NEW shapes so later rollbacks fit
        if not self._checkpoint():
            return    # poisoned right now: the health path rolls back
        self._sync()
        with telemetry.span("runner.degrade", action=action,
                            chunk=self._last_saved_chunk):
            self.sim, _ = self._elastic(new_cfg, self._last_saved_chunk)
        self.degrades += 1
        self.sim.lifecycle["degrade_events"] += 1
        self._checkpoint()

    # ------------------------------------------------------------- misc
    def preempt(self):
        """External preemption signal (a SIGTERM handler calls this); the
        loop drains at the next chunk boundary."""
        self.preempted = True

    def _heartbeat(self, chunk: int):
        if self.cfg.heartbeat_path and self.sim.is_writer:
            # staleness self-check: a previous beat older than the
            # watchdog's threshold means the interval overran; count it
            # before publishing the fresh beat
            if self.cfg.heartbeat_max_age_s is not None:
                _, _, verdict = read_heartbeat(
                    self.cfg.heartbeat_path,
                    max_age_s=self.cfg.heartbeat_max_age_s)
                if verdict == "stale":
                    self.sim.lifecycle["heartbeat_stale"] += 1
            write_heartbeat(self.cfg.heartbeat_path,
                            {"chunk": chunk,
                             "lifecycle": dict(self.sim.lifecycle)})

    # -------------------------------------------------------- main loop
    def run(self, num_chunks: int) -> str:
        """Advance ``num_chunks`` chunks past the CURRENT chunk (a runner
        resumed at chunk j with run(k - j) lands exactly on chunk k).
        Returns "done" or "preempted"."""
        end = self.sim.chunk + int(num_chunks)
        if self._last_saved_chunk is None:
            # an initial verified checkpoint: rollback always has a target
            if not self._checkpoint():
                raise RuntimeError("initial state is unhealthy")
        while True:
            cur = self.sim.chunk
            if self.preempted:
                self._checkpoint()
                self._sync()
                return "preempted"
            if cur >= end:
                break
            stats_before = self.sim.stats()
            self.sim.run(min(self.cfg.ckpt_every, end - cur))
            for hook in list(self.chaos_hooks):
                hook(self)
            cur = self.sim.chunk
            self._heartbeat(cur)
            # the cheap per-interval poll of the last chunk's verdict
            if self.sim.health()["health_flags"] != 0:
                self._rollback()
                continue
            self._maybe_degrade(stats_before, self.sim.stats())
            if not self._checkpoint():
                # the state was poisoned between the chunk and the save
                self._rollback()
        if self._last_saved_chunk != self.sim.chunk:
            self._checkpoint()
        self._sync()
        return "done"
