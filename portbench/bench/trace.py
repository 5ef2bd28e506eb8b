"""The traced window: a ``torch.profiler`` session over the device and the
host, and its reduction to what the per-layer readers take.

Re-implements ``chip_smoke.py::ranges_by_launch`` / ``phase_profile``:
a kernel, copy or set belongs to a host range (``record_function``) when
the runtime call that launched it (matched through the correlation id)
falls inside the range. Device busy time is the union of the device
operations' intervals; the idle share is one less busy over the window.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


class Trace:
    """What one profiled window gives: ``ranges`` (name -> device_ms,
    launches, count, span_ms), ``kernels`` (name -> device_ms, count),
    ``sample`` (the kernels launched inside ``portbench.sample`` ranges),
    ``busy_s``, ``window_s`` and ``breakdown``."""

    def __init__(self, events):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window range")
        lo = min(e["ts"] for e in win)
        hi = max(e["ts"] + e["dur"] for e in win)
        self.window_s = (hi - lo) / 1e6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and lo <= e["ts"] <= hi]
        self.busy_s = _union(dev) / 1e6
        self.kernels = collections.defaultdict(
            lambda: {"device_ms": 0.0, "count": 0})
        for e in dev:
            k = self.kernels[e["name"]]
            k["device_ms"] += e["dur"] / 1e3
            k["count"] += 1
        self.kernels = dict(self.kernels)
        self.ranges, self.sample = _ranges(events, dev)
        self.breakdown = {
            "device_ops": [[n, k["device_ms"] / 1e3] for n, k in sorted(
                self.kernels.items(), key=lambda kv: -kv[1]["device_ms"])
                [:10]],
            "idle_gaps": _idle_gaps(events, dev, lo, hi)}

    def kernel_ms(self, *names, sample: bool = False) -> float:
        """Device ms of the kernels named one of ``names`` (the function's
        name in the demangled signature; in the sample ranges only with
        ``sample``)."""
        src = self.sample if sample else self.kernels
        return sum(v["device_ms"] for k, v in src.items()
                   if _named(k, names))

    def kernel_count(self, *names) -> int:
        return sum(v["count"] for k, v in self.kernels.items()
                   if _named(k, names))


def _named(signature: str, names) -> bool:
    """Whether a demangled kernel signature (``void (anonymous
    namespace)::dq_wgmma<...>(...)``) is the function of one of
    ``names``."""
    return any(re.search(rf"(^|[\s:]){re.escape(n)}[<(]", signature)
               for n in names)


def _union(dev) -> float:
    """Microseconds in which at least one device operation ran."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _ranges(events, dev):
    dur = {e.get("args", {}).get("correlation"): e for e in dev}
    launches = sorted((e["ts"], dur[c]) for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      for c in (e.get("args", {}).get("correlation"),)
                      if c is not None and c in dur)
    starts = [t for t, _ in launches]
    out, sample = {}, collections.defaultdict(
        lambda: {"device_ms": 0.0, "count": 0})
    for r in events:
        if r.get("cat") != "user_annotation":
            continue
        a, b = r["ts"], r["ts"] + r["dur"]
        i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
        inside = [launches[k][1] for k in range(i, j)]
        acc = out.setdefault(r["name"], {"count": 0, "span_ms": 0.0,
                                         "device_ms": 0.0, "launches": 0})
        acc["count"] += 1
        acc["span_ms"] += r["dur"] / 1e3
        acc["device_ms"] += sum(e["dur"] for e in inside) / 1e3
        acc["launches"] += len(inside)
        if r["name"] == "portbench.sample":
            for e in inside:
                sample[e["name"]]["device_ms"] += e["dur"] / 1e3
                sample[e["name"]]["count"] += 1
    return out, dict(sample)


def _idle_gaps(events, dev, lo, hi, top: int = 10):
    """The device's idle gaps inside the window, summed by the innermost
    host range open when each began (nested ranges: the one that started
    last among those still open): [[range, seconds], ...]."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps, end = [], lo
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    ann = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] != WINDOW)
    starts = [x[0] for x in ann]
    by = collections.Counter()
    for a, b in gaps:
        inner = "host (no range)"
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if ann[i][1] >= a:
                inner = ann[i][2]
                break
        by[inner] += (b - a) / 1e6
    return [[n, s] for n, s in by.most_common(top)]


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (device and host); on exit ``out["trace"]`` is
    its ``Trace``. The Chrome trace goes to a temporary file that is
    removed once read."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out["trace"] = Trace(events)
    out["read_s"] = time.perf_counter() - t
