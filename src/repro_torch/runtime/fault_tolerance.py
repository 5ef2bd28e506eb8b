"""The heartbeat file of a long run: the port's copy of the heartbeat half
of the JAX package's ``repro/runtime/fault_tolerance.py``. An external
watchdog reads it and restarts a run whose beat has gone stale;
``runtime.sim_runner.SimulationRunner`` writes it every interval."""
from __future__ import annotations

import json
import os
import time
from typing import Optional


def write_heartbeat(path: str, payload: dict):
    """Atomically publish a heartbeat JSON (``payload`` + a ``t``
    timestamp): write a sibling temp file, then ``os.replace``, so readers
    see either the previous heartbeat or the new one, never a torn
    write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dict(payload, t=time.time()), f)
    os.replace(tmp, path)


def read_heartbeat(path: str, max_age_s: Optional[float] = None,
                   now: Optional[float] = None):
    """Watchdog-side read of an atomic heartbeat: returns
    ``(payload, age_s, verdict)`` with verdict one of ``'fresh'``,
    ``'stale'`` (age over ``max_age_s``), ``'missing'`` (no or garbled
    file: a torn write cannot happen, so unreadable JSON means the process
    never completed a heartbeat). ``now`` overrides the clock for tests."""
    try:
        with open(path) as f:
            payload = json.load(f)
        t = float(payload["t"])
    except (OSError, ValueError, KeyError, TypeError):
        return None, None, "missing"
    age = (time.time() if now is None else now) - t
    if max_age_s is not None and age > max_age_s:
        return payload, age, "stale"
    return payload, age, "fresh"
