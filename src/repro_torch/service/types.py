"""Request/response types, typed rejections, and the slot lifecycle
state machine of the multi-tenant simulation service: the port's copy of
the JAX package's ``repro/service/types.py`` (host code only).

A *request* is one tenant's scenario instance: a per-slot seed, a chunk
budget, a priority, and optional deadline/retry semantics. The service
multiplexes admitted requests over slots (one lane of
``repro_torch.service.slots.SlotBatch`` each); everything in this module is
host-side bookkeeping.

Typed rejections (admission control never queues unboundedly):

  ``ServiceOverloaded``     the bounded queue is full: shed at submit;
  ``IncompatibleRequest``   the request cannot run on this service's
                            template (chunk budget over the admission
                            cap, non-positive budget, ...);
  ``ServiceConfigError``    the service template itself is unusable (no
                            slot, or a shared batch of another width).

Slot lifecycle (one slot)::

    EMPTY --admit--> RUNNING --chunk==budget--> DONE        (slot freed)
    RUNNING --deadline expired @ boundary--> DEADLINE_EXCEEDED  (freed)
    RUNNING --shed (degradation ladder)--> SHED                 (freed)
    RUNNING --health flags / stall watchdog--> quarantine:
        retries left    --> BACKOFF --expiry--> RUNNING
                            (lane restored from its slot snapshot)
        retries spent   --> FAILED | STALLED                    (freed)

``RequestStatus`` mirrors the request's view of that machine; a freed
slot returns to EMPTY and the next queued request is admitted into it.

``RequestHandle._next_id`` is one counter for the process: the retry
jitter hashes the handle's id (``service._jitter``), so a backoff's delay
depends on how many handles were made before it.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class ServiceError(Exception):
    """Base class for every typed service error."""


class ServiceOverloaded(ServiceError):
    """Admission rejection: all slots busy and the bounded queue is at
    capacity. The submit is shed immediately — never queued unboundedly.
    Carries the observed depth so clients can back off intelligently."""

    def __init__(self, msg: str, queue_depth: int = 0,
                 queue_cap: int = 0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.queue_cap = queue_cap


class IncompatibleRequest(ServiceError):
    """Admission rejection: the request cannot run on this service's slot
    template (e.g. chunk budget over the admission cap)."""


class ServiceConfigError(ServiceError):
    """The service template config cannot serve multi-tenant slots."""


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    BACKOFF = "backoff"              # quarantined, awaiting retry
    DONE = "done"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    SHED = "shed"                    # evicted by the degradation ladder
    STALLED = "stalled"              # watchdog verdict, retries spent
    FAILED = "failed"                # health verdict, retries spent

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.QUEUED, RequestStatus.RUNNING,
                            RequestStatus.BACKOFF)


@dataclasses.dataclass
class SimRequest:
    """One tenant's scenario instance. ``seed`` keys every source of
    randomness for the instance (init + the counter-based in-run hash),
    so the result is bit-identical to a solo ``Simulator`` run with
    ``BrainConfig(seed=seed)`` regardless of slot placement or
    co-tenants. ``chunks`` is the chunk budget (one chunk = Delta
    activity steps + one connectivity update); ``deadline_s`` is wall
    clock from submission, checked cooperatively at chunk boundaries."""
    seed: int
    chunks: int
    priority: int = 0                # higher = survives shedding longer
    deadline_s: Optional[float] = None
    max_retries: int = 2
    tag: str = ""


@dataclasses.dataclass
class BackoffRecord:
    """One retry backoff: scheduled at ``tick``, slot resumes (snapshot
    restored) ``delay_ticks`` later. Delays grow exponentially with
    ``attempt`` plus deterministic jitter (service.py)."""
    attempt: int
    delay_ticks: int
    tick: int
    reason: str = "health"           # 'health' | 'stall'


@dataclasses.dataclass
class TenantResult:
    """Delivered when the request leaves the service (any terminal
    status). ``observations`` is the streamed per-tick observable rows
    (tick, chunk, mean rate, mean calcium, live out-edges) harvested
    while the tenant ran; ``counters`` the tenant's own device metrics
    (summed over ranks) at eviction."""
    status: RequestStatus
    chunks_done: int
    retries: int
    backoffs: List[BackoffRecord]
    observations: Any                # (ticks, 5) float ndarray
    counters: Dict[str, float]
    final_state: Any = None          # the lane's global BrainState, if kept


class RequestHandle:
    """The client's view of a submitted request."""

    _next_id = 0

    def __init__(self, request: SimRequest, deadline_at: Optional[float]):
        RequestHandle._next_id += 1
        self.id = RequestHandle._next_id
        self.request = request
        self.status = RequestStatus.QUEUED
        self.deadline_at = deadline_at   # time.monotonic() absolute
        self.slot: Optional[int] = None
        self.chunks_done = 0
        self.retries = 0
        self.backoffs: List[BackoffRecord] = []
        self.observations: List[Any] = []
        self.result: Optional[TenantResult] = None

    def __repr__(self):
        return (f"RequestHandle(id={self.id}, status={self.status.value}, "
                f"slot={self.slot}, chunks={self.chunks_done}/"
                f"{self.request.chunks})")
