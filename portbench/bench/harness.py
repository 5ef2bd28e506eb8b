"""The harness: finds a cell's configuration, traffic mix, driver and
per-layer readers by name, runs the cell once and prints its result.

Everything that belongs to one configuration, mix or metric is a file of
its own, found from ``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the configuration as it is run;
- ``portbench/traffic/<traffic>.json``: the mix's parameters, among them
  ``driver``, the module ``portbench/drivers/<driver>.py`` that runs it;
- ``portbench/layer_metrics/<metric>.py``: a reader, ``read(ctx)``, that
  returns the metric from the traced window or None.

A driver's ``run(r)`` (``r`` a ``Run``) builds the program, warms up,
calls ``r.setup_done()``, measures for ``r.seconds`` (profiled when
``r.trace``), compares what the timed path produced with the plain
reference and returns an ``Outcome``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that must print no result (exit code 2)."""


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict              # name -> value (the driver's own units)
    checks: dict                  # name -> (value, limit): value <= limit
    memory_peak_bytes: int
    units: int = 0                # chunks or steps in the traced window
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    @property
    def correct(self) -> bool:
        return all(v is not None and math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


class Run:
    """One run of one cell: its arguments, files and clocks."""

    def __init__(self, spec, cell, seed, seconds, trace, device, t0,
                 config=None, traffic=None):
        self.spec, self.cell = spec, cell
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = device
        self.t0 = t0
        self.config = config or load_json(
            BENCH / "configs" / f"{cell['config']}.json")
        self.traffic = traffic or load_json(
            BENCH / "traffic" / f"{cell['traffic']}.json")
        self.setup_s = None

    def setup_done(self):
        """Ends the set-up: everything up to the first timed work."""
        self.setup_s = time.perf_counter() - self.t0


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root=ROOT) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def find_cell(spec, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def driver_for(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(name: str):
    """The reader module of a per-layer metric, by its file name."""
    path = BENCH / "layer_metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_of(spec, cell) -> list:
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def per_layer_of(spec, cell) -> list:
    """The per-layer metrics this cell reports: those that list it, or
    that list no cells and move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class ReaderContext:
    """What a per-layer reader sees: the traced window's ``trace``, the
    ``units`` (chunks or steps) in it, the driver's ``work`` counts, the
    ``config`` and ``traffic`` dicts and the cell."""

    def __init__(self, run: Run, outcome: Outcome):
        self.trace = outcome.trace
        self.units = outcome.units
        self.work = outcome.work
        self.config = run.config
        self.traffic = run.traffic
        self.cell = run.cell


def run_cell(run: Run) -> dict:
    """Runs the cell and returns the result line (a dict)."""
    out = driver_for(run.traffic).run(run)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that the benchmark may not load: "
                      f"{found}")
    if run.trace:
        ctx = ReaderContext(run, out)
        metrics = {}
        for m in per_layer_of(run.spec, run.cell):
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_of(run.spec, run.cell)}
    device = {"platform": "gpu" if run.device.type == "cuda" else
              run.device.type,
              "kind": _device_kind(run.device), "count": 1,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return line


def _device_kind(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_spec()
        cell = find_cell(spec, args.workload)
        src = ROOT / "src"
        if not (src / "repro_torch").is_dir():
            raise Refused(f"the program (src/repro_torch) is not in {ROOT}")
        sys.path.insert(0, str(src))
        import torch
        # one process with one CPU thread of its own: the host's work is
        # the launches of one thread, and a pool of CPU threads would only
        # contend for the host's cores with it
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell needs {cell['chips']} CUDA device(s); "
                          f"this machine shows "
                          f"{torch.cuda.device_count()}")
        run = Run(spec, cell, args.seed, args.seconds, args.trace,
                  torch.device("cuda", 0), t0)
        line = run_cell(run)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for k, c in line["compared"].items():
        print(f"portbench: {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
