"""Host-side tracing: wall-clock spans and ``torch.profiler`` ranges; the
port's copy of the JAX package's ``repro/telemetry/trace.py``.

``span(name)`` is a context manager that (a) records a wall-clock span
(start, duration, nesting depth, parent) into a process-wide ring of the
last 4,096 spans and (b) opens ``torch.profiler.record_function("repro." +
name)``, so the same region shows up as a named range in a captured
``torch.profiler`` trace. The Simulator, the runner, the assimilation loop
and the service open their spans here; the phases of a chunk open their
``repro.*`` ranges with ``record_function`` directly (``sim/phases.py``).

The nesting stack is per thread: ``dist.LocalComm`` runs each rank in a
thread of its own, and a rank's spans nest only in that thread's.

``profile(log_dir)`` runs a ``torch.profiler.profile`` over its block and
writes a Chrome trace into ``log_dir``; a failure to start warns and the
block runs unprofiled. Profiling is opt-in observability, never something
a result depends on.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function

_MAX_SPANS = 4096
_records: "deque[Span]" = deque(maxlen=_MAX_SPANS)
_records_lock = threading.Lock()
_tls = threading.local()


@dataclass
class Span:
    """One completed (or in-flight) wall-clock span."""
    name: str
    start_s: float              # perf_counter at entry
    duration_ms: float = -1.0   # -1 while still open
    depth: int = 0
    parent: Optional[str] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    def asdict(self) -> dict:
        return {"name": self.name, "start_s": self.start_s,
                "duration_ms": self.duration_ms, "depth": self.depth,
                "parent": self.parent, "attrs": dict(self.attrs)}


def _stack() -> List[Span]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record a named wall-clock span (and a profiler range ``repro.`` +
    ``name``). Yields the Span record; callers may add ``attrs`` to it."""
    stack = _stack()
    rec = Span(name=name, start_s=time.perf_counter(), depth=len(stack),
               parent=stack[-1].name if stack else None, attrs=dict(attrs))
    stack.append(rec)
    try:
        with record_function("repro." + name):
            yield rec
    finally:
        stack.pop()
        rec.duration_ms = (time.perf_counter() - rec.start_s) * 1e3
        with _records_lock:
            _records.append(rec)


def spans(name: Optional[str] = None) -> List[Span]:
    """Completed spans so far (oldest first), optionally filtered by name."""
    with _records_lock:
        out = list(_records)
    return out if name is None else [s for s in out if s.name == name]


def clear() -> None:
    with _records_lock:
        _records.clear()


def export() -> List[dict]:
    """JSON-serializable span records."""
    return [s.asdict() for s in spans()]


@contextlib.contextmanager
def profile(log_dir: Optional[str]):
    """``torch.profiler.profile`` over the block, its Chrome trace written to
    ``<log_dir>/trace.json``; a no-op on None, and a warning (the block runs
    unprofiled) when the profiler fails to start or to write."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:  # a profiler already running, no backend
        warnings.warn(f"telemetry: profiler trace not captured: {e}")
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        except Exception as e:
            warnings.warn(f"telemetry: profiler trace not finalized: {e}")
