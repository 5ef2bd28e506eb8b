#!/usr/bin/env python3
"""Where the host time of a tree-assembly call goes.

    python3 tools/tree_call_split.py

Calls ``repro_torch.kernels.leaf_sums.assemble`` on the card at ``CONFIG``
(init_state's positions and vacancies at R=1, (rel, slot) from K3) and
times, on the host clock, the mean of ``REPS`` calls of each part of the
wrapper: the operand casts, ``_outputs`` (the one allocation and its
views), ``_launch`` (the C entry and the cooperative launch) and the whole
call; then the whole call with CUDA events around ``REPS`` back-to-back
calls, as ``chip_smoke.py`` times it. ``REPS`` stays below the depth of the
launch queue, so the host never waits for the card. Prints one JSON line
with the card's name and power limit.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.msp_brain import CONFIG  # noqa: E402
from repro_torch.connectome import tree as ctree  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import leaf_sums as ls  # noqa: E402
from repro_torch.kernels import radix_sort as rs  # noqa: E402

REPS = 200


def host_us(fn) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    us = (time.perf_counter() - t0) / REPS * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("tree_call_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg, dev = CONFIG, torch.device("cuda")
    _build.library()
    st = engine.init_state(cfg, 0, 1, device=dev)
    pos, w = st.positions, st.neurons.de_elements
    leaf_level, n_leaf, base = ctree._tree_geometry(0, cfg, 1)
    rel, slot = rs.morton_sort(pos, base * 8 ** cfg.local_levels,
                               leaf_level=leaf_level, n_leaf=n_leaf)
    levels, m, n = cfg.local_levels, 4, w.shape[0]
    stream = _build.stream(dev.index)
    held = ls._outputs(n, n_leaf, levels, m, dev)   # the launch's buffer
    ptrs = held[0]
    cast = _build.as_dtype
    parts = {
        "casts": host_us(lambda: (cast(pos, torch.float32),
                                  cast(w, torch.float32),
                                  cast(rel, torch.int32),
                                  cast(slot, torch.int32))),
        "outputs": host_us(lambda: ls._outputs(n, n_leaf, levels, m, dev)),
        "launch": host_us(lambda: ls._launch(pos, w, rel, slot, ptrs, n_leaf,
                                             levels, m, stream)),
        "call": host_us(lambda: ls.assemble(pos, w, rel, slot, n_leaf,
                                            levels, m)),
    }
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        ls.assemble(pos, w, rel, slot, n_leaf, levels, m)
    b.record()
    torch.cuda.synchronize()
    print(json.dumps({"tool": "tree_call_split", "card": card,
                      "n": n, "n_leaf": n_leaf, "levels": levels + 1,
                      "host_us": parts,
                      "call_ms_events": a.elapsed_time(b) / REPS}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
