#!/usr/bin/env python3
"""Time two checkouts of the repo in turns on one GPU.

    git archive PARENT | tar -x -C build/parent
    python3 tools/compare_trees.py build/parent . . build/parent

For each tree, in the order given, in fresh processes: that tree's
``chip_smoke.py`` (its JSON lines go to
``chiprun_out/compare_trees/<k>-<tree>.jsonl``), then, importing that tree's
``chip_smoke``, K1 at R=4 rank 1 (``k1_timing``) and K1's kernel time of one
window from a ``torch.profiler`` trace (the sum of its kernels' durations,
R=1 with the scenario's lesion and R=4 rank 1), K0's device launches and
kernel time for one (n, 3) ``prng.uniform`` and ``init_state``'s Threefry
launches, and one profiled chunk of the main path (the reference apply
lowering: its retraction and formation ranges); then, in the tree,
``tools/k8_call_split.py`` (K8's call time by part). Among the numbers compared:
each kernel's call and device ms (K1-K5, retraction), the three paths'
chunk time and peak memory, the profiled chunk's ranges, and the profiled
multi-rank chunk's device busy time and phase A's device time. Each tree builds its
kernels under its own ``build/``. Prints one JSON line per run, then a table of the
numbers compared, the card's name and power limit on each line. A key a tree's
``chip_smoke.py`` does not print (a kernel it does not have) shows as None.
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


def device_events(fn, reps=1):
    # the device events (kernels, copies, memsets) and the gpu ranges of
    # reps calls of fn under the profiler, from its Chrome trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace("build/compare_probe_trace.json")
    with open("build/compare_probe_trace.json") as f:
        ev = json.load(f)["traceEvents"]
    dev = [e for e in ev
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return dev, [e for e in ev if e.get("cat") == "gpu_user_annotation"]


# K0: one (n, 3) uniform from a key tensor, and init_state's draws
from repro_torch import prng
from repro_torch.core import engine
n = cfg.neurons_per_rank
key = prng.key(cfg.seed, device="cuda")
prng.uniform(key, (n, 3))
dev, _ = device_events(lambda: prng.uniform(key, (n, 3)), 10)
out["K0_uniform_n3_device_launches"] = len(dev) / 10
out["K0_uniform_n3_kernel_ms"] = sum(e["dur"] for e in dev) / 10 / 1e3
dev, _ = device_events(lambda: engine.init_state(cfg, 0, 1, device="cuda"))
out["init_state_threefry_launches"] = sum(
    1 for e in dev if "threefry" in e["name"] or "draw_kernel" in e["name"])
out["init_state_device_launches"] = len(dev)
# the main path (reference apply lowering): one chunk after a warm-up
from repro_torch.sim.api import Simulator
main_cfg = dataclasses.replace(CONFIG, activity_impl="fused",
                               connectivity_impl="fused")
sim = Simulator.from_config(main_cfg, device="cuda")
sim.run(1)
dev, ranges = device_events(sim.step)
for r in ranges:
    if r["name"] in ("repro.conn.retraction", "repro.conn.formation"):
        a, b = r["ts"], r["ts"] + r["dur"]
        inside = [e for e in dev if a <= e["ts"] < b]
        tag = r["name"].split(".")[-1]
        out[f"main_{tag}_device_ms"] = sum(e["dur"] for e in inside) / 1e3
        out[f"main_{tag}_launches"] = len(inside)
        out[f"main_{tag}_span_ms"] = r["dur"] / 1e3
out["main_chunk_device_ms"] = sum(e["dur"] for e in dev) / 1e3
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
    split = subprocess.run([sys.executable,
                            str(ROOT / "tools" / "k8_call_split.py")],
                           cwd=tree, capture_output=True, text=True,
                           timeout=600)
    for line in split.stdout.splitlines():
        if line.startswith("K8SPLIT "):
            k8 = json.loads(line[8:])
            for variant in ("homogeneous", "heterogeneous"):
                extra[f"K8_{variant}_call_ms"] = k8[variant]["call_ms"]
                extra[f"K8_{variant}_split_ms"] = k8[variant]["split_ms"]
    api = {(c.get("kernel"), c.get("variant")): c for c in
           lines.get("kernel_api", {}).get("checks", [])}
    for variant in ("homogeneous", "heterogeneous"):
        c = api.get(("K8 neuron_step", variant), {})
        extra[f"K8_{variant}_ms"] = c.get("ms")
        extra[f"K8_{variant}_device_ms"] = c.get("device_ms")
        extra[f"K8_{variant}_empty_kernel_device_ms"] = c.get(
            "empty_kernel_device_ms")
    kt = lines.get("kernel_times", {})
    prof = lines.get("profile", {}).get("ranges", {})
    mr_prof = lines.get("profile_multi_rank_path", {})
    res = {"run": k, "tree": name, "card": card(),
           "chip_smoke_rc": smoke.returncode, "probe_rc": probe.returncode,
           "K0_ms": kt.get("K0_ms"), "K0_device_ms": kt.get("K0_device_ms"),
           "K1_ms": kt.get("K1_ms"), "K1_device_ms": kt.get("K1_device_ms"),
           **extra,
           "K2_ms": kt.get("K2_ms"), "K2_device_ms": kt.get("K2_device_ms"),
           "K2_bound_ms": kt.get("K2_bound_ms"),
           "retract_device_ms": kt.get("retract_device_ms"),
           "retract_sparse_device_ms": kt.get("retract_sparse_device_ms"),
           "edge_priority_device_ms": kt.get("edge_priority_device_ms"),
           "K4_drain_device_ms": kt.get("K4_drain_device_ms"),
           "K4_accept_device_ms": kt.get("K4_accept_device_ms"),
           "K4_drain_ms": kt.get("K4_drain_ms"),
           "K4_accept_ms": kt.get("K4_accept_ms"),
           "K3_ms": kt.get("K3_ms"), "K3_device_ms": kt.get("K3_device_ms"),
           "K5_ms": kt.get("K5_ms"), "K5_device_ms": kt.get("K5_device_ms"),
           "K5_caller_inputs_device_ms": kt.get(
               "K5_caller_inputs_device_ms"),
           "main_chunk_ms": lines.get("main_path", {}).get("median_chunk_ms"),
           "scenario_chunk_ms": lines.get("scenario_path", {}).get(
               "median_chunk_ms"),
           "main_peak_mem_gb": lines.get("main_path", {}).get("peak_mem_gb"),
           "scenario_peak_mem_gb": lines.get("scenario_path", {}).get(
               "peak_mem_gb"),
           "profiled_activity_device_ms": prof.get("repro.activity", {}).get(
               "device_ms"),
           "profiled_retraction_device_ms": prof.get(
               "repro.conn.retraction", {}).get("device_ms"),
           "profiled_retraction_launches": prof.get(
               "repro.conn.retraction", {}).get("launches"),
           "profiled_retraction_span_ms": prof.get(
               "repro.conn.retraction", {}).get("span_ms"),
           "profiled_tree_build_device_ms": prof.get(
               "repro.conn.tree_build", {}).get("device_ms"),
           "profiled_tree_build_launches": prof.get(
               "repro.conn.tree_build", {}).get("launches"),
           "profiled_formation_device_ms": prof.get(
               "repro.conn.formation", {}).get("device_ms"),
           "profiled_formation_span_ms": prof.get(
               "repro.conn.formation", {}).get("span_ms"),
           "profiled_device_busy_ms": lines.get("profile", {}).get(
               "device_busy_ms"),
           "profiled_chunk_wall_ms": lines.get("profile", {}).get(
               "chunk_wall_ms"),
           "multi_rank_chunk_ms": lines.get("multi_rank_path", {}).get(
               "median_chunk_ms"),
           "multi_rank_peak_mem_gb": lines.get("multi_rank_path", {}).get(
               "peak_mem_gb"),
           "multi_rank_profiled_busy_ms": mr_prof.get("device_busy_ms"),
           "multi_rank_phase_a_device_ms": mr_prof.get(
               "ranges_by_launch", {}).get("repro.conn.phase_a", {}).get(
               "device_ms")}
    if probe.returncode:
        res["probe_err"] = probe.stderr[-2000:]
    if split.returncode:
        res["k8_split_err"] = split.stderr[-2000:]
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
                                            "probe_err", "k8_split_err")]
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
