"""Unified telemetry export: one JSON schema for every bench script and the
regression gate.

The port of the JAX package's ``repro/telemetry/report.py``: the same
``repro.telemetry/v1`` schema, the same blocks and the same ``normalize``
(which also reads the pre-schema flat ``BENCH_*.json`` layouts), so a report
of either package reads the same. A report merges:

  * measured device counters/histograms (``telemetry.metrics.Metrics``,
    via ``counters_block``): per-rank values next to totals;
  * host-side span timings (``telemetry.trace.export``);
  * the dry run's analytic bytes and flops (``roofline_block``, from a
    ``launch/dryrun.py`` record or a ``launch/roofline.py::analyze``
    result, on the H100 terms of ``roofline.HW``).

Schema (``repro.telemetry/v1``)::

    {"schema": "repro.telemetry/v1", "bench": "<family>", "smoke": bool,
     "mesh": {"num_ranks": R, "backend": "cuda" | "cpu"},
     "cases": {"<case>": {"params": {...}, "metrics": {...}}},
     "counters": {...}?, "histograms": {...}?, "spans": [...]?,
     "lifecycle": {...}?, "service": {...}?, "quality": {...}?,
     "roofline": {...}?}

``mesh_block(num_ranks, device)`` gives ``backend`` "cuda" where the
caller ran on the card.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

SCHEMA = "repro.telemetry/v1"

# params are case *shape*, never regression-checked as metrics
PARAM_KEYS = ("n_per_rank", "num_ranks", "s_max", "delta", "chunks",
              "phase_b_queries")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def timing(compile_ms: float, steady_us: float, unit: str = "chunk") -> dict:
    """The compile/steady split every bench emits."""
    return {"compile_ms": float(compile_ms),
            f"steady_us_per_{unit}": float(steady_us)}


def mesh_block(num_ranks: int, device=None) -> dict:
    """``{"num_ranks", "backend"}``: "cuda" where ``device`` is the card."""
    dev = torch.device(device) if device is not None else None
    return {"num_ranks": int(num_ranks),
            "backend": dev.type if dev is not None else "cpu"}


def counters_block(metrics) -> dict:
    """Serialize a ``telemetry.metrics.Metrics``: summed totals AND the
    per-rank vectors (nothing collapsed), plus the health gauges
    (``health_flags`` reduces with max: a bitmask, not a total)."""
    tot, per_rank = {}, {}
    for k, v in metrics.counters.items():
        a = _np(v)
        tot[k] = float(a.sum())
        per_rank[k] = [float(x) for x in a.reshape(-1)]
    out = {"total": tot, "per_rank": per_rank}
    gauges = getattr(metrics, "gauges", None)
    if gauges:
        out["gauges"] = {
            k: float(_np(v).max() if k == "health_flags" else _np(v).sum())
            for k, v in gauges.items()}
    return out


def lifecycle_block(lifecycle: dict) -> dict:
    """Serialize the runner lifecycle counters (checkpoint saves/restores,
    rollbacks, restarts, degrade events): host-side ints from
    ``Simulator.lifecycle`` / ``Simulator.stats()``."""
    return {k: int(v) for k, v in lifecycle.items()}


def service_block(stats: dict, handles=None) -> dict:
    """Serialize a multi-tenant service run: the service lifecycle counters
    plus a per-terminal-status census of the submitted requests."""
    out = {"lifecycle": {k: int(v) for k, v in stats.items()}}
    if handles is not None:
        census: Dict[str, int] = {}
        for h in handles:
            s = h.status.value
            census[s] = census.get(s, 0) + 1
        out["requests"] = census
    return out


def quality_block(metrics: dict) -> dict:
    """Serialize workload *function* metrics (engram recall, assimilation
    error) in the same schema as the perf counters."""
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def histograms_block(metrics) -> dict:
    return {k: _np(v).sum(axis=0).tolist() for k, v in metrics.hists.items()}


_TERMS = ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
          "roofline_fraction")


def roofline_block(source: dict) -> dict:
    """The analytic bytes and flops of one traced step, the report's third
    source: ``source`` is a ``launch/dryrun.py`` record or a
    ``launch/roofline.py::analyze`` result. The keys of the JAX block:
    collective wire bytes by kind and their total, dot flops, materialized
    bytes, and the roofline terms (the record's own; for an ``analyze``
    result, ``roofline_terms`` on the materialized bytes)."""
    from repro_torch.launch import roofline as rl
    if "collective_wire_bytes" in source:          # an analyze() result
        wire = source["collective_wire_bytes"]
        total = source["collective_bytes_total"]
        flops = source["dot_flops"]
        mat = source.get("materialized_bytes", 0)
        terms = rl.roofline_terms(flops, mat, source.get(
            "collective_wire_bytes_by_link", total))
    else:                                         # a dry-run record
        wire = source["collectives"]
        total = source["collective_bytes_per_dev"]
        flops = source["dot_flops_per_dev"]
        mat = source.get("materialized_bytes", 0)
        terms = {k: source[k] for k in _TERMS}
    return {"collective_wire_bytes": wire, "collective_bytes_total": total,
            "dot_flops": flops, "materialized_hbm_bytes": mat,
            "terms": terms}


def make_report(bench: str, cases: Dict[str, dict], *, smoke: bool = False,
                mesh: Optional[dict] = None, counters: Optional[dict] = None,
                histograms: Optional[dict] = None,
                spans: Optional[list] = None,
                roofline: Optional[dict] = None,
                lifecycle: Optional[dict] = None,
                service: Optional[dict] = None,
                quality: Optional[dict] = None) -> dict:
    rep = {"schema": SCHEMA, "bench": bench, "smoke": bool(smoke),
           "cases": cases}
    if service is not None:
        rep["service"] = service
    if quality is not None:
        rep["quality"] = quality_block(quality)
    if mesh is not None:
        rep["mesh"] = mesh
    if counters is not None:
        rep["counters"] = counters
    if histograms is not None:
        rep["histograms"] = histograms
    if spans is not None:
        rep["spans"] = spans
    if roofline is not None:
        rep["roofline"] = roofline
    if lifecycle is not None:
        rep["lifecycle"] = lifecycle_block(lifecycle)
    return rep


def case(params: dict, metrics: dict) -> dict:
    return {"params": {k: _num(v) for k, v in params.items()},
            "metrics": {k: _num(v) for k, v in metrics.items()}}


def _num(v):
    if isinstance(v, (bool, str)):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def write(path: str, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------- normalize
def _split_case(d: dict) -> dict:
    params = {k: d[k] for k in PARAM_KEYS if k in d}
    metrics = {k: float(v) for k, v in d.items()
               if k not in params and isinstance(v, (int, float))
               and not isinstance(v, bool)}
    return {"params": params, "metrics": metrics}


def normalize(obj: dict, bench: Optional[str] = None) -> dict:
    """Canonical view ``{"bench", "smoke", "cases": {name: {"params",
    "metrics"}}}`` of either a v1 report or a pre-schema flat
    ``BENCH_*.json`` (old-activity: flat case at top level; old
    connectivity/spikes: {"smoke": bool, "<case>": {...}})."""
    if obj.get("schema") == SCHEMA:
        return {"bench": obj.get("bench", bench), "smoke": obj.get("smoke",
                False), "cases": obj["cases"]}
    if "n_per_rank" in obj:                       # old flat single-case
        name = f"n{int(obj['n_per_rank'])}"
        return {"bench": bench, "smoke": bool(obj.get("smoke", False)),
                "cases": {name: _split_case(obj)}}
    cases = {k: _split_case(v) for k, v in obj.items()
             if isinstance(v, dict)}
    return {"bench": bench, "smoke": bool(obj.get("smoke", False)),
            "cases": cases}
