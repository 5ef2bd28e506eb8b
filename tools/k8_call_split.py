#!/usr/bin/env python3
"""Where the host time of a K8 call goes, in the checkout it runs from.

    cd <checkout> && python3 <this repo>/tools/k8_call_split.py

Calls ``repro_torch.kernels.neuron_step.neuron_step`` at ``CONFIG``'s
65,536 neurons on the card, homogeneous and with ``baseline_growth``'s
per-neuron table, and times (host clock, mean of 2,000 calls) each part of
the wrapper by its helpers (``_inputs``, ``_tail``, ``_outputs``,
``_launch``; ``chip_smoke.k8_call_split`` of this repo) where the
checkout's wrapper has them, and in any checkout the whole call (CUDA
events around 2,000 calls). Prints one JSON line.
``tools/compare_trees.py`` runs it in each tree.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

sys.path.insert(0, "src")       # the checkout's port
sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs.msp_brain import CONFIG  # noqa: E402
from repro_torch.core.neuron import NeuronParams  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import neuron_step as ns  # noqa: E402
from repro_torch.scenarios import library  # noqa: E402
from repro_torch.scenarios.populations import table_for  # noqa: E402

REPS = 2000


def call_ms(x, cfg, params) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ns.neuron_step(*x, cfg, params=params)
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        ns.neuron_step(*x, cfg, params=params)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_call_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg, n, dev = CONFIG, CONFIG.neurons_per_rank, torch.device("cuda")
    _build.library()
    g = torch.Generator(device=dev).manual_seed(13)
    x = (torch.randn(n, generator=g, device=dev) * 5 - 60,
         torch.randn(n, generator=g, device=dev) * 2 - 13,
         torch.rand(n, generator=g, device=dev) * 0.01,
         torch.rand(n, generator=g, device=dev) * 2,
         torch.rand(n, generator=g, device=dev) * 2,
         torch.randn(n, generator=g, device=dev) * 5)
    t = table_for(cfg, library.baseline_growth(), n, device=dev)
    hetero = NeuronParams(t.izh_a, t.izh_b, t.izh_c, t.izh_d, t.growth_rate,
                          t.target_calcium)
    split = all(hasattr(ns, f) for f in ("_inputs", "_tail", "_outputs",
                                         "_launch"))
    out = {"card": card, "n": n}
    for name, params in (("homogeneous", None), ("heterogeneous", hetero)):
        out[name] = {"call_ms": call_ms(x, cfg, params), "split_ms":
                     chip_smoke.k8_call_split(x, cfg, params, REPS)
                     if split else None}
    print("K8SPLIT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
