#!/usr/bin/env python3
"""Where a call of K3 (``csrc/morton_sort.cu``), of K5 (``route_build``
in ``csrc/synapse_apply.cu``) and of the tree assembly
(``csrc/leaf_sums.cu``) spends its time, on one GPU.

    python3 tools/k35_breakdown.py

Builds each source with ``-DREPRO_K35_BREAKDOWN`` and the port's nvcc flags
into ``build/k35_breakdown/``: in that build thread 0 of every block stamps
the global timer at the end of each step of the kernel. The wrappers are
pointed at that build and called at ``chip_smoke.py``'s shapes (``check_k3``:
CONFIG's neurons into 4,096 cells; ``check_k5``: a lesion-sized retraction,
half of 2,097,152 entries valid, into the lesion cap; the assembly at R=1
on init_state's tree and with all 65,536 rows in one leaf, as rank 2 of the
R=4 surrogate has them). After the device time
of 20 calls (``chip_smoke.device_ms``), the stamps of one more call give
each step's end in us from the first block's start: the earliest, mean and
latest block that stamped it. Empty cooperative kernels at the same grids,
with 0, 1, 2 and 5 grid barriers, give the launch's and a barrier's own
device time. Prints one JSON line per measurement, the card's name and power limit
first. Reads the sources, writes only under ``build/``.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k35_breakdown"

K3_STEPS = ("start", "encoded", "row written", "first barrier", "scanned",
            "second barrier", "offsets loaded", "walked")
K5_STEPS = ("start", "counted", "barrier", "starts and totals",
            "placing (blocks that place)", "placed (blocks that place)",
            "end")
TREE_STEPS = ("start", "zeroed", "counted", "scanned", "placed",
              "leaves summed", "end")

EMPTY_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void syncs(int k) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < k; ++i) g.sync();
}
extern "C" int syncs_run(int grid, int threads, int k, void* stream) {
  void* args[] = {&k};
  return (int)cudaLaunchCooperativeKernel((const void*)syncs, grid, threads,
                                          args, 0, (cudaStream_t)stream);
}
"""


def nvcc(src: pathlib.Path, so: pathlib.Path, flags) -> None:
    from repro_torch.kernels import _build
    r = subprocess.run([_build._nvcc(), *flags, "-shared", str(src), "-o",
                        str(so)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed:\n{r.stdout}{r.stderr}")


def variant(source: str, entries, marks: str, rows: int):
    """The breakdown build of one source, its C entries declared."""
    from repro_torch.kernels import _build
    so = OUT / f"{source}.so"
    nvcc(_build.CSRC / f"{source}.cu", so,
         (*_build.NVCC_FLAGS, "-DREPRO_K35_BREAKDOWN"))
    lib = ctypes.CDLL(str(so))
    for name in entries:
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    name = f"{entries[0]}_workspace"
    if hasattr(lib, name):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    getattr(lib, marks).argtypes = [ctypes.c_void_p]
    getattr(lib, marks).restype = ctypes.c_int
    lib.marks_buffer = (ctypes.c_longlong * (rows * 8))()
    return lib


def stamps(lib, marks: str, rows: int, steps) -> dict:
    """Each step's end over the blocks that stamped it: [earliest, mean,
    latest] us from the first block's start, and the number of blocks."""
    if getattr(lib, marks)(ctypes.addressof(lib.marks_buffer)):
        raise RuntimeError(f"{marks} failed")
    t = [list(lib.marks_buffer[r * 8:(r + 1) * 8]) for r in range(rows)]
    t0 = min(r[0] for r in t if r[0])
    out = {}
    for k, name in enumerate(steps):
        got = [(r[k] - t0) / 1e3 for r in t if r[k]]
        if got:
            out[name] = {"blocks": len(got), "us": [
                min(got), sum(got) / len(got), max(got)]}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k35_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.msp_brain import CONFIG
    from repro_torch.connectome import routing
    from repro_torch.connectome import tree as ctree
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import leaf_sums as ls
    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels import synapse_apply as sa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "empty.cu").write_text(EMPTY_CU)
    nvcc(OUT / "empty.cu", OUT / "empty.so", _build.NVCC_FLAGS)
    empty = ctypes.CDLL(str(OUT / "empty.so"))
    empty.syncs_run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    k3 = variant("morton_sort", ("repro_morton_sort",), "repro_k3_marks", 256)
    k5 = variant("synapse_apply", ("repro_route_build",), "repro_k5_marks",
                 1024)
    tree = variant("leaf_sums", ("repro_tree_assemble",), "repro_tree_marks",
                   256)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = _build.stream()

    cfg = CONFIG
    st = engine.init_state(cfg, 0, 1, device="cuda")
    pos = st.positions
    leaf_level, n_leaf, base_cell = ctree._tree_geometry(0, cfg, 1)
    base = base_cell * 8 ** cfg.local_levels
    n, s = cfg.neurons_per_rank, cfg.max_synapses
    g = torch.Generator(device="cuda").manual_seed(7)
    m = n * s
    other = torch.randint(0, n, (m,), generator=g, device="cuda",
                          dtype=torch.int32)
    other = torch.where(torch.rand(m, generator=g, device="cuda") < 0.5, -1,
                        other)
    mine = torch.arange(m, device="cuda", dtype=torch.int32) // s
    cap = routing.cap_deletions(cfg, True)
    rel, slot = rs.morton_sort(pos, base, leaf_level=leaf_level,
                               n_leaf=n_leaf)
    one = torch.zeros(n, dtype=torch.int32, device="cuda")
    every = torch.arange(n, dtype=torch.int32, device="cuda")
    w = st.neurons.de_elements
    levels = cfg.local_levels
    runs = (
        ("K3", k3, "repro_k3_marks", 256, K3_STEPS, (sms, 512),
         lambda: rs.morton_sort(pos, base, leaf_level=leaf_level,
                                n_leaf=n_leaf),
         {"n": n, "leaf_level": leaf_level, "n_leaf": n_leaf}),
        ("K5", k5, "repro_k5_marks", 1024, K5_STEPS, (4 * sms, 256),
         lambda: sa.route_build(other, mine, n=n, num_ranks=1, cap=cap),
         {"entries": m, "R": 1, "cap": cap}),
        ("tree assembly", tree, "repro_tree_marks", 256, TREE_STEPS,
         (sms, 512),
         lambda: ls.assemble(pos, w, rel, slot, n_leaf, levels, 4),
         {"n": n, "n_leaf": n_leaf, "levels": levels + 1}),
        ("tree assembly, one leaf", tree, "repro_tree_marks", 256,
         TREE_STEPS, (sms, 512),
         lambda: ls.assemble(pos, w, one, every, n_leaf, levels, 4),
         {"n": n, "n_leaf": n_leaf, "levels": levels + 1,
          "fullest_leaf": n}))
    library = _build.library
    try:
        for name, lib, marks, rows, steps, grid, call, shape in runs:
            _build.library = lambda lib=lib: lib   # the wrapper runs the build
            dev_ms = cs.device_ms(call, 20)
            stamps(lib, marks, rows, steps)        # clears the stamps
            call()
            torch.cuda.synchronize()
            print(json.dumps({"card": card, "kernel": name, "shape": shape,
                              "device_ms": dev_ms,
                              "steps": stamps(lib, marks, rows, steps)}),
                  flush=True)
            for k in (0, 1, 2, 5):
                t = cs.device_ms(lambda: empty.syncs_run(
                    grid[0], grid[1], k, stream), 20)
                print(json.dumps({"card": card, "empty_cooperative": {
                    "grid": grid[0], "threads": grid[1], "grid_syncs": k},
                    "device_ms": t}), flush=True)
    finally:
        _build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
