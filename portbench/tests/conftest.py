"""Shared pieces of the benchmark's CPU tests: small configurations of
each cell, run through the harness on the CPU with the program's plain
versions (``run_small``)."""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the qwen2-7b smoke widths (src/repro_torch/configs/qwen2_7b.py)
LM_SMALL = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                vocab_size=512)
# the brain's SMOKE_CONFIG sizes (src/repro_torch/configs/msp_brain.py)
BRAIN_SMALL = dict(neurons=64, local_levels=3, frontier_cap=32,
                   max_synapses=8, lowerings="reference")
# tolerances of the small LM against its reference, bf16 at 64 wide:
# the readings on seeds 1-3 (loss 5.2e-4, first gradients 2.2e-3 at the
# worst leaf and 9.1e-4 on the mean, change 5.0e-2, at the largest) with
# room; the float8 control read 1.8e-3, 1.5e-2, 4.3e-3 and 1.8e-2 at the
# least
LM_SMALL_LIMITS = {"loss_gap": 2e-3, "grad_norm_gap": 1e-2,
                   "grad_norm_gap_mean": 3e-3, "change_gap": 0.1}


def small_run(cell_name: str, seed: int = 12345, seconds: float = 0.2,
              trace: bool = False, limits=None, **traffic):
    """A ``harness.Run`` of the cell at a small size on the CPU."""
    import torch
    from portbench.bench import harness
    spec = harness.load_spec()
    cell = harness.find_cell(spec, cell_name)
    cfg = harness.load_json(harness.BENCH / "configs" /
                            f"{cell['config']}.json")
    tr = harness.load_json(harness.BENCH / "traffic" /
                           f"{cell['traffic']}.json")
    if tr["driver"] == "brain":
        cfg.update(BRAIN_SMALL)
        tr.update(trace_episodes=1, k2_sample_chunk=2)
        if tr["scenario"] is None:
            tr.update(chunks_per_episode=4)
    else:
        cfg.update(LM_SMALL)
        cfg["limits"] = dict(limits or LM_SMALL_LIMITS)
        tr.update(seq_len=64, trace_steps=2, token_pool=8)
    tr.update(traffic)
    return harness.Run(spec, cell, seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter(), config=cfg,
                       traffic=tr)
