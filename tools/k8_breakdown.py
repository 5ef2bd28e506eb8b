#!/usr/bin/env python3
"""Split K8's device time at CONFIG's 65,536 neurons into its parts.

    python3 tools/k8_breakdown.py

Builds ``src/repro_torch/csrc/neuron_step.cu`` alone with
``-DREPRO_K8_BREAKDOWN`` (the same loads and stores with one add between
them instead of the model's arithmetic; the library build never defines it)
into ``build/k8_breakdown/``, then times on the card, each with the calls
queued behind a device-side sleep (``chip_smoke.device_ms``): the library's
kernel, the empty kernel of its grid and the copy-through variant, for the
homogeneous and the heterogeneous (``baseline_growth``) parameters, with
the operands in L2 (the same inputs every call) and cold (a 128 MB write
between calls; that write's own time, measured alone, is subtracted).
Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.msp_brain import CONFIG  # noqa: E402
from repro_torch.core.neuron import NeuronParams  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import neuron_step as ns  # noqa: E402
from repro_torch.scenarios import library  # noqa: E402
from repro_torch.scenarios.populations import table_for  # noqa: E402

REPS = 200


def build_copy_through() -> ctypes.CDLL:
    """``csrc/neuron_step.cu`` built alone with ``-DREPRO_K8_BREAKDOWN``."""
    out = ROOT / "build" / "k8_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk8_copy_through.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
         "-DREPRO_K8_BREAKDOWN", "-I", str(_build.CSRC),
         str(_build.CSRC / "neuron_step.cu"), "-o", str(so)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    if proc.returncode:
        raise SystemExit(f"k8_breakdown: nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.repro_neuron_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_neuron_step.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    copy = build_copy_through()
    lib = _build.library()
    cfg, n, dev = CONFIG, CONFIG.neurons_per_rank, torch.device("cuda")
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
    index = x[0].get_device()
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    out = {"card": card, "n": n}
    for name, params in (("homogeneous", None), ("heterogeneous", hetero)):
        ins, _ = ns._inputs(x, index)
        tail, _ = ns._tail(cfg, params, index, [])
        outs, base, step = ns._outputs(n, dev)     # kept while timed
        args = ns._ARGS.pack(*(y.data_ptr() for y in ins), base,
                             base + step, base + 2 * step, base + 3 * step,
                             base + 4 * step, base + 5 * step, tail, n, 0)
        stream = _build.stream(index)
        calls = {"kernel": lambda: lib.repro_neuron_step(args, stream),
                 "empty_kernel": lambda: lib.repro_neuron_step_floor(
                     args, stream),
                 "copy_through": lambda: copy.repro_neuron_step(args,
                                                                stream)}
        res = {}
        for label, fn in calls.items():
            res[f"{label}_device_ms"] = cs.device_ms(fn, REPS)
            flush_ms = cs.device_ms(lambda: flush.fill_(1.0), 20)

            def cold(fn=fn):
                flush.fill_(1.0)
                fn()
            res[f"{label}_cold_device_ms"] = cs.device_ms(cold, 20) - flush_ms
        out[name] = res
    print("K8BREAKDOWN " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
