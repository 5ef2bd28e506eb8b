#!/usr/bin/env python3
"""Where a step of K1 (``csrc/activity_window.cu``) spends its time, on one
GPU.

    python3 tools/k1_breakdown.py

Builds the kernel's source with ``-DREPRO_K1_BREAKDOWN`` and the port's
nvcc flags into ``build/k1_breakdown/``: that build's entry
``repro_k1_parts_off`` switches parts of a step off (bit 1: the synaptic
sums; bit 2: the noise draw; bit 4: the bitmap copy). The wrapper is pointed
at that build, and times one window of 1 and of 101 steps at ``CONFIG``'s width (R=1, and
R=4 rank 1 with remote edges): the difference over 100 is the time of a step
with those parts off. A cooperative kernel that only runs 100 grid barriers
(with and without the 8 KB bitmap copy) gives the barrier's own cost. Times
are device times (``chip_smoke.device_ms``); prints one JSON line per
measurement and the card's name and power limit first. Reads the source,
writes only under ``build/``.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k1_breakdown"
PARTS = {0: "all", 1: "no sums", 2: "no noise", 4: "no bitmap copy",
         7: "none of the three"}

BARRIER_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void barriers(const unsigned* bits, int words, int steps) {
  extern __shared__ unsigned s[];
  cg::grid_group g = cg::this_grid();
  unsigned acc = 0;
  for (int t = 0; t < steps; ++t) {
    for (int w = threadIdx.x; w < words; w += blockDim.x) s[w] = __ldcg(bits + w);
    __syncthreads();
    if (words) acc += s[(threadIdx.x * 7) % words];
    g.sync();
  }
  if (acc == 0xdeadbeefu) s[0] = acc;
}
extern "C" int barriers_run(int grid, int threads, int steps, const void* bits,
                            int words, void* stream) {
  void* args[] = {&bits, &words, &steps};
  return (int)cudaLaunchCooperativeKernel((const void*)barriers, grid, threads,
                                          args, words * 4, (cudaStream_t)stream);
}
"""


def nvcc(src: pathlib.Path, so: pathlib.Path, flags) -> None:
    from repro_torch.kernels import _build
    r = subprocess.run([_build._nvcc(), *flags, "-shared", str(src), "-o",
                        str(so)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed:\n{r.stdout}{r.stderr}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.msp_brain import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.kernels import activity_fused as af
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "barriers.cu").write_text(BARRIER_CU)
    nvcc(_build.CSRC / "activity_window.cu", OUT / "variant.so",
         (*_build.NVCC_FLAGS, "-DREPRO_K1_BREAKDOWN"))
    nvcc(OUT / "barriers.cu", OUT / "barriers.so", _build.NVCC_FLAGS)
    var = ctypes.CDLL(str(OUT / "variant.so"))
    for name in ("repro_activity_window",
                 "repro_activity_window_device_launches"):
        getattr(var, name).argtypes = _build.SIGNATURES[name]
        getattr(var, name).restype = ctypes.c_int
    var.repro_k1_parts_off.argtypes = [ctypes.c_int]
    bar = ctypes.CDLL(str(OUT / "barriers.so"))
    bar.barriers_run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p]

    words = (CONFIG.neurons_per_rank + 31) // 32
    bits = torch.zeros(words, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    grid = -(-CONFIG.neurons_per_rank // 512)
    for w in (0, words):
        t = {k: cs.device_ms(lambda: bar.barriers_run(
            grid, 512, k, bits.data_ptr(), w, stream), 5) for k in (1, 101)}
        print(json.dumps({"card": card, "part": "grid barrier",
                          "bitmap_words_copied": w, "blocks": grid,
                          "us_per_step": (t[101] - t[1]) / 100 * 1e3}),
              flush=True)

    _build.library = lambda: var       # the wrapper launches the variant
    cfg = CONFIG
    for ranks, rank in ((1, 0), (4, 1)):
        state, edges, w, rates, izh = cs.k1_inputs(cfg, ranks, rank)
        for mask, label in PARTS.items():
            var.repro_k1_parts_off(mask)
            t = {}
            for steps in (1, 101):
                kw = dict(seed=cfg.seed, num_steps=steps, izh=izh,
                          ca_consts=(cfg.calcium_decay, cfg.calcium_beta))
                t[steps] = cs.device_ms(lambda: af.activity_window(
                    state, edges, w, rates, cfg.background_mean,
                    cfg.background_std, 0, rank, **kw), 5)
            print(json.dumps({"card": card, "R": ranks, "rank": rank,
                              "n": cfg.neurons_per_rank,
                              "S": cfg.max_synapses, "parts": label,
                              "us_per_step": (t[101] - t[1]) / 100 * 1e3,
                              "one_step_window_ms": t[1]}), flush=True)
    var.repro_k1_parts_off(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
