#!/usr/bin/env python3
"""Time two checkouts of the repo in turns on one GPU.

    git archive PARENT | tar -x -C build/parent
    python3 tools/compare_trees.py build/parent . . build/parent

For each tree, in the order given, in fresh processes: that tree's
``chip_smoke.py`` (its JSON lines go to
``chiprun_out/compare_trees/<k>-<tree>.jsonl``), then, importing that tree's
``chip_smoke``, K1 at R=4 rank 1 (``k1_timing``) and K1's kernel time of one
window from a ``torch.profiler`` trace (the sum of its kernels' durations,
R=1 with the scenario's lesion and R=4 rank 1). Each tree builds its kernels
under its own ``build/``. Prints one JSON line per run, then a table of the
numbers compared, the card's name and power limit on each line.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "compare_trees"

# run inside a tree: K1 at R=4 and K1's profiled kernel time
PROBE = r"""
import dataclasses, json, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs.msp_brain import CONFIG
from repro_torch.kernels import _build
from repro_torch.kernels import activity_fused as af
from repro_torch.scenarios import library
_build.build()
cfg = dataclasses.replace(CONFIG, activity_impl="fused",
                          connectivity_impl="fused", tree_impl="fused",
                          apply_impl="fused")
r4 = cs.k1_timing(cfg, 4, 1)
out = {"K1_R4_ms": r4[0], "K1_R4_device_ms": r4[1]}
lesions = cs.scenario_lesions(cfg, library.lesion_rewiring())
for label, ranks, rank, les in (("R1", 1, 0, lesions), ("R4", 4, 1, None)):
    state, edges, w, rates, izh = cs.k1_inputs(cfg, ranks, rank)
    kw = dict(seed=cfg.seed, num_steps=cfg.rate_period, izh=izh,
              ca_consts=(cfg.calcium_decay, cfg.calcium_beta), lesions=les)
    args = (state, edges, w, rates, cfg.background_mean, cfg.background_std,
            0, rank)
    af.activity_window(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            af.activity_window(*args, **kw)
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0)
             for e in prof.key_averages() if "activity_" in e.key)
    out[f"K1_{label}_kernel_ms"] = us / 3 / 1e3
print("PROBE " + json.dumps(out), flush=True)
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def run_tree(k: int, tree: pathlib.Path) -> dict:
    name = "this" if tree.resolve() == ROOT else tree.name
    path = OUT / f"{k}-{name}.jsonl"
    smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
    path.write_text(smoke.stdout + "\n# stderr\n" + smoke.stderr[-20000:])
    lines = {}
    for line in smoke.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            lines[obj.get("phase", "kernels" if "kernels" in obj else "ok")] \
                = obj
    probe = subprocess.run([sys.executable, "-c", PROBE], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
    extra = {}
    for line in probe.stdout.splitlines():
        if line.startswith("PROBE "):
            extra = json.loads(line[6:])
    kt = lines.get("kernel_times", {})
    prof = lines.get("profile", {}).get("ranges", {})
    res = {"run": k, "tree": name, "card": card(),
           "chip_smoke_rc": smoke.returncode, "probe_rc": probe.returncode,
           "K1_ms": kt.get("K1_ms"), "K1_device_ms": kt.get("K1_device_ms"),
           **extra,
           "K4_drain_device_ms": kt.get("K4_drain_device_ms"),
           "K4_accept_device_ms": kt.get("K4_accept_device_ms"),
           "K4_drain_ms": kt.get("K4_drain_ms"),
           "K4_accept_ms": kt.get("K4_accept_ms"),
           "main_chunk_ms": lines.get("main_path", {}).get("median_chunk_ms"),
           "scenario_chunk_ms": lines.get("scenario_path", {}).get(
               "median_chunk_ms"),
           "profiled_activity_device_ms": prof.get("repro.activity", {}).get(
               "device_ms"),
           "profiled_retraction_device_ms": prof.get(
               "repro.conn.retraction", {}).get("device_ms"),
           "profiled_device_busy_ms": lines.get("profile", {}).get(
               "device_busy_ms"),
           "profiled_chunk_wall_ms": lines.get("profile", {}).get(
               "chunk_wall_ms")}
    if probe.returncode:
        res["probe_err"] = probe.stderr[-2000:]
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    trees = [pathlib.Path(t) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    runs = [run_tree(k, t) for k, t in enumerate(trees)]
    keys = [k for k in runs[0] if k not in ("run", "tree", "card",
                                            "probe_err")]
    print("| quantity | " + " | ".join(f"{r['run']}: {r['tree']}"
                                       for r in runs) + " |")
    for key in keys:
        print(f"| {key} | " + " | ".join(str(r.get(key)) for r in runs)
              + " |")
    print(f"card: {runs[0]['card']}")
    return 0 if all(r["chip_smoke_rc"] == 0 and r["probe_rc"] == 0
                    for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
