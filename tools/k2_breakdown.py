#!/usr/bin/env python3
"""Where K2 (``csrc/bh_traverse.cu``) spends its work and its cycles, on one
GPU.

    python3 tools/k2_breakdown.py

Builds the kernel's source with ``-DREPRO_K2_BREAKDOWN`` and the port's nvcc
flags into ``build/k2_breakdown/``: that build counts, per call, the queries
(and the valid ones), the restart rounds each query ran, the sub-rounds of
each round and the valid frontier entries entering them, the sub-rounds that
ended at the fixed point, node evaluations and Gumbel draws, and sums the
clock64() cycles of a query's parts (node statistics; scans and frontier
writes; the Gumbel pass; member selection; the whole query), read through
``repro_k2_breakdown``. Two sets of inputs, both at ``CONFIG``'s width: the
``chip_smoke.k2_inputs`` tree (every neuron a valid query from cell 0) and
the inputs K2 receives on the scenario path (``lesion_rewiring``, all five
lowerings fused), captured at three chunks. Beside each, the library
build's device time (``chip_smoke.device_ms``). Prints the card's name and
power limit, then one JSON line per input set. Reads the source, writes only
under ``build/``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k2_breakdown"
SCENARIO_CHUNKS = (1, 6, 11)     # before the lesion at step 1,000 and after

NAMES = ("queries", "valid_queries", "rounds", "queries_1_round",
         "queries_2_rounds", "queries_3plus_rounds", "node_evaluations",
         "frontier_draws", "member_draws", "subrounds_r0", "subrounds_r1",
         "subrounds_r2plus", "entries_r0", "entries_r1", "entries_r2plus",
         "fixed_point_r0", "fixed_point_r1", "fixed_point_r2plus",
         "cycles_node_stats", "cycles_scans_writes", "cycles_gumbel",
         "cycles_members", "cycles_query")


def summary(c: dict) -> dict:
    """Per-query and per-round shares of the raw counters."""
    q = max(c["queries"], 1)
    out = {"per_query": {k: c[k] / q for k in (
        "rounds", "node_evaluations", "frontier_draws", "member_draws")}}
    rounds = {"r0": c["queries"], "r1": c["queries_2_rounds"]
              + c["queries_3plus_rounds"], "r2plus": c["rounds"]
              - c["queries"] - c["queries_2_rounds"]
              - c["queries_3plus_rounds"]}
    out["per_round"] = {
        r: {"rounds": rounds[r],
            "subrounds_per_round": c[f"subrounds_{r}"] / max(rounds[r], 1),
            "mean_entries": c[f"entries_{r}"] / max(c[f"subrounds_{r}"], 1),
            "fixed_point_share": c[f"fixed_point_{r}"] / max(rounds[r], 1)}
        for r in rounds}
    total = max(c["cycles_query"], 1)
    parts = ("cycles_node_stats", "cycles_scans_writes", "cycles_gumbel",
             "cycles_members")
    out["cycle_shares"] = {k[7:]: c[k] / total for k in parts}
    out["cycle_shares"]["other"] = 1.0 - sum(c[k] for k in parts) / total
    out["cycles_per_query"] = c["cycles_query"] / q
    return out


def scenario_inputs(cfg, chunks):
    """K2's arguments on the scenario path at the given chunks (the
    wrapper is wrapped to keep them)."""
    from repro_torch.kernels import bh_traverse as bt
    from repro_torch.scenarios import library
    from repro_torch.sim.api import Simulator
    kept, real = {}, bt.bh_traverse
    sim = Simulator.from_config(cfg, scenario=library.lesion_rewiring(),
                                device="cuda")

    def keep(*args, **kw):
        if args[9] in chunks:                # the call's chunk
            kept[args[9]] = (args, kw)
        return real(*args, **kw)

    bt.bh_traverse = keep
    try:
        sim.run(max(chunks) + 1)
    finally:
        bt.bh_traverse = real
    return kept


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.msp_brain import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.kernels import bh_traverse as bt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "variant.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DREPRO_K2_BREAKDOWN", "-shared",
                        str(_build.CSRC / "bh_traverse.cu"), "-o", str(so)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc bh_traverse.cu failed:\n{r.stdout}"
                           f"{r.stderr}")
    var = ctypes.CDLL(str(so))
    var.repro_bh_traverse.argtypes = _build.SIGNATURES["repro_bh_traverse"]
    var.repro_bh_traverse.restype = ctypes.c_int
    var.repro_k2_breakdown.argtypes = [ctypes.c_void_p, ctypes.c_int]
    var.repro_k2_breakdown.restype = ctypes.c_int
    n_counters = var.repro_k2_breakdown_counters()
    real = _build.library()

    class Variant:
        """The library, with K2's entry taken from the breakdown build."""

        def __getattr__(self, name):
            return getattr(var if name == "repro_bh_traverse" else real,
                           name)

    def breakdown(args, kw) -> dict:
        words = (ctypes.c_ulonglong * n_counters)()
        torch.cuda.synchronize()
        _build.check(var.repro_k2_breakdown(words, 1), "k2 breakdown reset")
        _build.library = Variant
        try:
            bt.bh_traverse(*args, **kw)
            torch.cuda.synchronize()
        finally:
            _build.library = lambda: real
        _build.check(var.repro_k2_breakdown(words, 1), "k2 breakdown read")
        return dict(zip(NAMES, list(words)))

    cfg = dataclasses.replace(CONFIG, activity_impl="fused",
                              connectivity_impl="fused", tree_impl="fused",
                              apply_impl="fused")
    args, kw, widths = cs.k2_inputs(cfg)
    sets = [("k2_inputs", args, dict(kw, widths=widths))]
    for chunk, (a, k) in sorted(scenario_inputs(cfg, SCENARIO_CHUNKS)
                                .items()):
        sets.append((f"scenario_chunk_{chunk}", a, k))
    for label, a, k in sets:
        counts = breakdown(a, k)
        dev_ms = cs.device_ms(lambda: bt.bh_traverse(*a, **k), 5)
        print(json.dumps({"card": card, "inputs": label,
                          "valid_queries": int(a[8].sum()),
                          "device_ms": dev_ms, "counters": counts,
                          **summary(counts)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
