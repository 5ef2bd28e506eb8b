"""SimulationService: the request-driven multi-tenant front end over a
``SlotBatch``; the port's copy of the JAX package's
``repro/service/service.py``, host code line for line.

One service = one slot template (BrainConfig + scenario + rank count) and
``num_slots`` lanes. Clients ``submit`` requests (per-tenant seed, chunk
budget, priority, deadline, retry policy) and receive a
``RequestHandle``; ``tick()`` advances every running lane one
boundary-aligned step and runs the whole robustness layer:

  admission      bounded priority queue, typed shed on overflow
                 (``ServiceOverloaded``), never unbounded;
  isolation      per-slot health verdicts (the in-chunk gauges + a
                 re-probe of the current state) quarantine ONLY the
                 offending lane; co-tenants continue bitwise as solo runs;
  retry          quarantined slots roll back to their last verified
                 snapshot after an exponential backoff with
                 deterministic jitter, bounded by ``max_retries``;
  deadlines      wall-clock deadlines are checked cooperatively at
                 chunk boundaries; expired requests cancel and free
                 their slot;
  watchdog       a slot whose chunk counter stops advancing for
                 ``stall_patience`` ticks is treated as stalled
                 (quarantine -> retry -> STALLED eviction);
  degradation    sustained overload or quarantine pressure walks a
                 ladder: (1) shrink the per-tick chunk count to its
                 floor, (2) shed the lowest-priority running tenant
                 (typed SHED eviction).

The tick is boundary-cooperative: the per-tick chunk count never
overshoots any running tenant's remaining budget, so completion,
cancellation, and eviction all happen at exact chunk boundaries, the
property that keeps every lane's trajectory bitwise a solo run.

What differs from the JAX service: the batch starts with empty slots (a
lane is made at admission, not for every slot at construction), and a tick
steps and reads only the lanes of RUNNING tenants (``slots.py``). So a
tenant evicted while in backoff reports the counters of its lane at the
quarantine; the JAX service's lane would have run on, poisoned, until then.
The lanes may run the fused lowerings (``slots.py``). Spans, events,
statuses, backoffs and ``stats()`` are the JAX service's.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch import telemetry
from repro_torch.checkpoint import manager
from repro_torch.core import engine
from repro_torch.runtime.fault_tolerance import write_heartbeat
from repro_torch.service.slots import SlotBatch
from repro_torch.service.types import (BackoffRecord, IncompatibleRequest,
                                 RequestHandle, RequestStatus,
                                 ServiceConfigError, ServiceOverloaded,
                                 SimRequest, TenantResult)

SERVICE_LIFECYCLE_KEYS = (
    "requests_admitted", "requests_completed", "requests_rejected",
    "requests_shed", "deadline_cancellations", "quarantines",
    "slot_rollbacks", "slot_evictions", "stall_evictions",
    "degrade_events", "snapshots", "ticks")


@dataclasses.dataclass
class ServiceConfig:
    """Host-side service knobs. ``chunks_per_tick`` is the degradation
    ladder's first rung (shrunk toward ``min_chunks_per_tick`` under
    pressure); ``queue_cap`` bounds admission. ``snapshot_every`` is in
    ticks; snapshots are probe-verified before capture so a rollback
    target is never poisoned (the runner's rule, per slot)."""
    num_slots: int = 4
    queue_cap: int = 8
    chunks_per_tick: int = 1
    min_chunks_per_tick: int = 1
    max_chunks_per_request: int = 100_000
    snapshot_every: int = 1
    # retry/backoff (ticks): delay = min(max, base * 2**(attempt-1)) + jitter
    backoff_base: int = 1
    backoff_max: int = 8
    # watchdog / degradation
    stall_patience: int = 4
    overload_patience: int = 3
    quarantine_patience: int = 3
    shed_enabled: bool = True
    # persistence / observability
    heartbeat_path: Optional[str] = None
    ckpt_dir: Optional[str] = None     # durable per-slot lane checkpoints
    keep_final_state: bool = True
    scrub_evicted: bool = True         # re-place snapshot over a poisoned
                                       # lane at eviction (numeric hygiene)


@dataclasses.dataclass
class _Slot:
    index: int
    handle: Optional[RequestHandle] = None
    seed: int = 0
    admit_tick: int = 0
    backoff_until: int = 0
    last_progress_tick: int = 0
    last_chunk: int = 0
    stall_ticks: int = 0               # chaos: ticks of simulated stall
    snap: object = None                # verified lane snapshot (a copy)
    snap_chunk: int = 0

    @property
    def busy(self) -> bool:
        return self.handle is not None


def _jitter(handle_id: int, attempt: int) -> int:
    """Deterministic 0/1-tick jitter (crc32 of the identity) — breaks
    retry synchronization between slots without nondeterminism."""
    return zlib.crc32(f"{handle_id}:{attempt}".encode()) & 1


class SimulationService:
    """Multi-tenant simulation service over one slot template, on the card
    unless ``device`` names another.

    >>> svc = SimulationService(cfg, ServiceConfig(num_slots=4))
    >>> h = svc.submit(SimRequest(seed=7, chunks=20))
    >>> svc.run_until_idle()
    >>> h.result.status
    <RequestStatus.DONE: 'done'>
    """

    def __init__(self, cfg, service_cfg: Optional[ServiceConfig] = None,
                 scenario=None, num_ranks: int = 1, device=None,
                 batch: Optional[SlotBatch] = None):
        self.cfg = cfg
        self.service_cfg = service_cfg or ServiceConfig()
        sc = self.service_cfg
        with telemetry.span("service.construct", slots=sc.num_slots):
            if batch is not None:
                # share one slot template (its contexts and rank group)
                # across service restarts (service state is reinitialised
                # below)
                if batch.num_slots != sc.num_slots:
                    raise ServiceConfigError(
                        f"shared batch has {batch.num_slots} slots, "
                        f"service config wants {sc.num_slots}")
                self.batch = batch
            else:
                self.batch = SlotBatch(cfg, sc.num_slots, scenario=scenario,
                                       num_ranks=num_ranks, device=device)
            self.slots = [_Slot(i) for i in range(sc.num_slots)]
            self._seeds = np.zeros(sc.num_slots, np.int32)
            # the lanes; a slot's lane is made when a request is admitted
            self.state = [None] * sc.num_slots
        self.queue: List = []          # heap of (-priority, seq, handle)
        self._seq = 0
        self.tick_count = 0
        self.chunks_per_tick = sc.chunks_per_tick
        self.lifecycle: Dict[str, int] = {k: 0
                                          for k in SERVICE_LIFECYCLE_KEYS}
        self.events: List[dict] = []
        self._overload_streak = 0
        self._quarantine_streak = 0
        # chaos hooks: callables(service) fired after every tick's step,
        # before the health read — the window a real fault occupies
        self.chaos_hooks: List = []

    # ------------------------------------------------------------ events
    def _event(self, kind: str, **fields):
        self.events.append(dict(fields, event=kind, tick=self.tick_count))

    # --------------------------------------------------------- admission
    def submit(self, request: SimRequest) -> RequestHandle:
        """Admit (or queue) one request. Raises ``IncompatibleRequest``
        for budgets the template cannot serve and ``ServiceOverloaded``
        when the bounded queue is full — submission never blocks and the
        queue never grows past ``queue_cap``."""
        sc = self.service_cfg
        if request.chunks <= 0 or \
                request.chunks > sc.max_chunks_per_request:
            raise IncompatibleRequest(
                f"chunk budget {request.chunks} outside "
                f"(0, {sc.max_chunks_per_request}]")
        handle = RequestHandle(
            request,
            deadline_at=(time.monotonic() + request.deadline_s
                         if request.deadline_s is not None else None))
        free = self._free_slot()
        if free is None and len(self.queue) >= sc.queue_cap:
            self.lifecycle["requests_rejected"] += 1
            self._event("rejected", request=handle.id,
                        queue_depth=len(self.queue))
            raise ServiceOverloaded(
                f"no free slot and queue at capacity "
                f"({len(self.queue)}/{sc.queue_cap})",
                queue_depth=len(self.queue), queue_cap=sc.queue_cap)
        if free is not None:
            self._admit(free, handle)
        else:
            self._seq += 1
            heapq.heappush(self.queue,
                           (-request.priority, self._seq, handle))
            self._event("queued", request=handle.id,
                        queue_depth=len(self.queue))
        return handle

    def _free_slot(self) -> Optional[_Slot]:
        for s in self.slots:
            if not s.busy:
                return s
        return None

    def _admit(self, slot: _Slot, handle: RequestHandle):
        """Place a fresh lane (per-slot seed) into the slot; co-tenant
        lanes pass through untouched. The fresh lane is referenced by
        nothing else, so it goes in as it is (not through ``place``'s
        copy); the snapshot taken below is the copy isolation needs."""
        req = handle.request
        with telemetry.span("service.admit", slot=slot.index,
                            request=handle.id):
            self.state = list(self.state)
            self.state[slot.index] = self.batch.init_lane(req.seed)
        slot.handle = handle
        slot.seed = req.seed
        slot.admit_tick = self.tick_count
        slot.backoff_until = 0
        slot.last_progress_tick = self.tick_count
        slot.last_chunk = 0
        slot.stall_ticks = 0
        slot.snap = self.batch.extract(self.state, slot.index)
        slot.snap_chunk = 0
        self._seeds[slot.index] = req.seed
        handle.status = RequestStatus.RUNNING
        handle.slot = slot.index
        self.lifecycle["requests_admitted"] += 1
        self.lifecycle["snapshots"] += 1
        self._event("admitted", request=handle.id, slot=slot.index,
                    seed=req.seed)

    # ---------------------------------------------------------- eviction
    def _finish(self, slot: _Slot, status: RequestStatus,
                keep_state: bool = False):
        """Terminal transition: deliver the TenantResult and free the
        slot. The lane stays as it is until re-admission (optionally
        scrubbed back to the last good snapshot first)."""
        handle = slot.handle
        counters = self.batch.counters(self.state, slot.index)
        # the lane's global view (rows in rank order), as Simulator.state
        final = engine.join_states(
            self.batch.extract(self.state, slot.index)) \
            if keep_state and self.service_cfg.keep_final_state else None
        handle.status = status
        handle.result = TenantResult(
            status=status, chunks_done=handle.chunks_done,
            retries=handle.retries, backoffs=list(handle.backoffs),
            observations=np.array(handle.observations, np.float64)
            if handle.observations else np.zeros((0, 5)),
            counters=counters, final_state=final)
        if status is not RequestStatus.DONE and \
                self.service_cfg.scrub_evicted and slot.snap is not None:
            self.state = self.batch.place(self.state, slot.snap,
                                          slot.index)
        slot.handle = None
        slot.snap = None
        slot.stall_ticks = 0
        if status is not RequestStatus.DONE:
            self.lifecycle["slot_evictions"] += 1
        self._event("finished", request=handle.id, slot=slot.index,
                    status=status.value, chunks=handle.chunks_done)

    # -------------------------------------------------------- quarantine
    def _quarantine(self, slot: _Slot, reason: str):
        """Per-slot fault handling: retries left -> schedule an
        exponential-backoff retry (the lane is restored from the
        verified snapshot at expiry); retries spent -> typed eviction."""
        handle = slot.handle
        self.lifecycle["quarantines"] += 1
        handle.retries += 1
        self._event("quarantined", request=handle.id, slot=slot.index,
                    reason=reason, attempt=handle.retries)
        if handle.retries > handle.request.max_retries:
            self._finish(slot, RequestStatus.STALLED if reason == "stall"
                         else RequestStatus.FAILED)
            return
        sc = self.service_cfg
        attempt = handle.retries
        delay = min(sc.backoff_max, sc.backoff_base * 2 ** (attempt - 1)) \
            + _jitter(handle.id, attempt)
        slot.backoff_until = self.tick_count + delay
        handle.status = RequestStatus.BACKOFF
        rec = BackoffRecord(attempt=attempt, delay_ticks=delay,
                            tick=self.tick_count, reason=reason)
        handle.backoffs.append(rec)
        with telemetry.span("service.backoff", slot=slot.index,
                            request=handle.id, attempt=attempt,
                            delay_ticks=delay, reason=reason):
            pass
        self._event("backoff", request=handle.id, slot=slot.index,
                    attempt=attempt, delay_ticks=delay)

    def _restore_slot(self, slot: _Slot):
        """Roll one lane back to its last verified snapshot — the
        slot-sliced version of the runner's checkpoint rollback. Every
        other lane passes through untouched."""
        with telemetry.span("service.rollback", slot=slot.index,
                            to_chunk=slot.snap_chunk):
            self.state = self.batch.place(self.state, slot.snap,
                                          slot.index)
        slot.last_chunk = slot.snap_chunk
        slot.last_progress_tick = self.tick_count
        slot.handle.chunks_done = slot.snap_chunk
        slot.handle.status = RequestStatus.RUNNING
        self.lifecycle["slot_rollbacks"] += 1
        self._event("rollback", request=slot.handle.id, slot=slot.index,
                    to_chunk=slot.snap_chunk)

    # ----------------------------------------------------------- ticking
    def _expire_deadlines(self):
        now = time.monotonic()
        # queued requests can expire before ever holding a slot
        kept = []
        for item in self.queue:
            h = item[2]
            if h.deadline_at is not None and now >= h.deadline_at:
                h.chunks_done = 0
                self.lifecycle["deadline_cancellations"] += 1
                self._event("deadline", request=h.id, slot=None)
                h.status = RequestStatus.DEADLINE_EXCEEDED
                h.result = TenantResult(
                    status=h.status, chunks_done=0, retries=0,
                    backoffs=[], observations=np.zeros((0, 5)),
                    counters={})
            else:
                kept.append(item)
        if len(kept) != len(self.queue):
            self.queue = kept
            heapq.heapify(self.queue)
        for slot in self.slots:
            h = slot.handle
            if h is not None and h.deadline_at is not None \
                    and now >= h.deadline_at:
                self.lifecycle["deadline_cancellations"] += 1
                self._event("deadline", request=h.id, slot=slot.index)
                self._finish(slot, RequestStatus.DEADLINE_EXCEEDED)

    def _admit_from_queue(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            _, _, handle = heapq.heappop(self.queue)
            self._admit(slot, handle)

    def _tick_chunks(self) -> int:
        """Boundary-cooperative chunk count: never overshoot any running
        tenant's remaining budget (cancellation/completion happen at
        exact chunk boundaries)."""
        k = self.chunks_per_tick
        for slot in self.slots:
            h = slot.handle
            if h is not None and h.status is RequestStatus.RUNNING:
                k = min(k, h.request.chunks - h.chunks_done)
        return max(k, 1)

    def tick(self) -> bool:
        """One service step. Returns True while there is work left."""
        sc = self.service_cfg
        self.tick_count += 1
        self.lifecycle["ticks"] += 1
        self._expire_deadlines()
        self._admit_from_queue()
        running = [s for s in self.slots if s.busy]
        if not running and not self.queue:
            return False
        k = self._tick_chunks()
        # the lanes that run and are read this tick: those of RUNNING
        # tenants (a lane in backoff is restored before it runs again)
        lanes = [s.index for s in running
                 if s.handle.status is RequestStatus.RUNNING]
        with telemetry.span("service.tick", tick=self.tick_count,
                            chunks=k, active=len(running)):
            for _ in range(k):
                self.state = self.batch.step(self.state, self._seeds, lanes)
        for hook in list(self.chaos_hooks):
            hook(self)
        # one read each of the in-chunk verdict, the current-state probe,
        # the per-slot chunk counters, and the observable rows
        flags = self.batch.health_flags(self.state, lanes) | \
            self.batch.probe(self.state, lanes)
        chunks = self.batch.chunks(self.state)
        obs = self.batch.observe(self.state, lanes)
        quarantined_now = 0
        for slot in self.slots:
            h = slot.handle
            if h is None:
                continue
            b = slot.index
            if h.status is RequestStatus.BACKOFF:
                if self.tick_count >= slot.backoff_until:
                    self._restore_slot(slot)
                continue
            # progress accounting (chaos stall freezes the credited
            # progress, emulating a tenant that stops advancing)
            if slot.stall_ticks > 0:
                slot.stall_ticks -= 1
            else:
                h.chunks_done = int(chunks[b]) - 0
                if int(chunks[b]) > slot.last_chunk:
                    slot.last_chunk = int(chunks[b])
                    slot.last_progress_tick = self.tick_count
            h.observations.append(
                np.concatenate(([float(self.tick_count)], obs[b])))
            if int(flags[b]) != 0:
                quarantined_now += 1
                self._quarantine(slot, "health")
                continue
            if self.tick_count - slot.last_progress_tick \
                    >= sc.stall_patience:
                quarantined_now += 1
                if slot.handle.retries >= slot.handle.request.max_retries:
                    self.lifecycle["stall_evictions"] += 1
                self._quarantine(slot, "stall")
                continue
            if h.chunks_done >= h.request.chunks:
                self.lifecycle["requests_completed"] += 1
                self._finish(slot, RequestStatus.DONE, keep_state=True)
                continue
            # probe-verified snapshot: the rollback target can never be
            # poisoned, and co-tenant lanes are not touched by capture
            if (self.tick_count - slot.admit_tick) \
                    % sc.snapshot_every == 0:
                slot.snap = self.batch.extract(self.state, b)
                slot.snap_chunk = h.chunks_done
                self.lifecycle["snapshots"] += 1
                if sc.ckpt_dir:
                    manager.save(
                        f"{sc.ckpt_dir}/slot{b}", h.chunks_done,
                        engine.join_states(slot.snap),
                        metadata={"request": h.id, "seed": slot.seed,
                                  "tag": h.request.tag})
        self._maybe_degrade(quarantined_now)
        self._admit_from_queue()
        self._heartbeat()
        return any(s.busy for s in self.slots) or bool(self.queue)

    # -------------------------------------------------------- degradation
    def _maybe_degrade(self, quarantined_now: int):
        """The ladder: sustained overload (full queue) or quarantine
        pressure first shrinks the per-tick chunk count (finer boundaries
        = faster slot turnover and cheaper rollback re-runs), then sheds
        the lowest-priority running tenant with a typed SHED eviction."""
        sc = self.service_cfg
        self._overload_streak = self._overload_streak + 1 \
            if len(self.queue) >= sc.queue_cap else 0
        self._quarantine_streak = self._quarantine_streak + 1 \
            if quarantined_now > 0 else 0
        pressured = (self._overload_streak >= sc.overload_patience or
                     self._quarantine_streak >= sc.quarantine_patience)
        if not pressured:
            return
        self._overload_streak = 0
        self._quarantine_streak = 0
        if self.chunks_per_tick > sc.min_chunks_per_tick:
            self.chunks_per_tick = max(sc.min_chunks_per_tick,
                                       self.chunks_per_tick // 2)
            action = "shrink_chunks_per_tick"
        elif sc.shed_enabled:
            victims = [s for s in self.slots if s.busy]
            if not victims:
                return
            victim = min(victims,
                         key=lambda s: (s.handle.request.priority,
                                        -s.handle.id))
            self.lifecycle["requests_shed"] += 1
            action = "shed_lowest_priority"
            self._event("shed", request=victim.handle.id,
                        slot=victim.index,
                        priority=victim.handle.request.priority)
            self._finish(victim, RequestStatus.SHED)
        else:
            return
        self.lifecycle["degrade_events"] += 1
        with telemetry.span("service.degrade", action=action,
                            chunks_per_tick=self.chunks_per_tick):
            pass
        self._event("degrade", action=action,
                    chunks_per_tick=self.chunks_per_tick)

    # ------------------------------------------------------------- misc
    def _heartbeat(self):
        if self.service_cfg.heartbeat_path:
            write_heartbeat(self.service_cfg.heartbeat_path, {
                "tick": self.tick_count,
                "slots": {s.index: (s.handle.id if s.busy else None)
                          for s in self.slots},
                "progress": {s.index: s.last_chunk for s in self.slots
                             if s.busy},
                "lifecycle": dict(self.lifecycle)})

    def run_until_idle(self, max_ticks: int = 10_000) -> dict:
        """Drive ``tick`` until queue and slots drain (or ``max_ticks``).
        Returns the service lifecycle counters."""
        with telemetry.span("service.run_until_idle"):
            for _ in range(max_ticks):
                if not self.tick():
                    break
        return dict(self.lifecycle)

    def stats(self) -> dict:
        """Service lifecycle counters + live occupancy."""
        out = dict(self.lifecycle)
        out["slots_busy"] = sum(1 for s in self.slots if s.busy)
        out["queue_depth"] = len(self.queue)
        out["chunks_per_tick"] = self.chunks_per_tick
        return out
