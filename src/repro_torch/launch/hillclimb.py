"""Automated hillclimbing over config overrides for one (arch, shape) cell,
on the dry run's H100 roofline: the port of the JAX package's
``repro/launch/hillclimb.py`` over ``python -m repro_torch.launch.dryrun``.

For each candidate change it (a) names the roofline term it attacks, (b)
traces the cell in a subprocess, (c) records confirmed/refuted. Greedy:
applies the best confirmed change and repeats until three consecutive
rounds improve the dominant term by <5%.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen2-7b \\
      --shape train_4k --rounds 3
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# candidate changes with a one-line hypothesis + which term they attack;
# every key is a field of ParallelConfig or ModelConfig (configs/base.py)
CANDIDATES = [
    (["layout=fsdp"], "collective",
     "TP all-reduces activations every layer; FSDP trades them for bf16 "
     "weight gathers ~3x params/dev"),
    (["remat=dots_saveable"], "compute",
     "full remat recomputes every dot in bwd; saving dot outputs removes "
     "the recompute flops"),
    (["moe_strategy=move_compute"], "collective",
     "paper's location-aware dispatch: tokens move, not expert weights"),
    (["moe_strategy=move_data"], "collective",
     "inverse: weights move once per layer; wins when T_dev*k*d > E*3*d*ff"),
    (["capacity_factor=1.0"], "compute",
     "MoE capacity padding is 25% wasted expert flops"),
    (["ce_mode=vocab_parallel"], "collective",
     "compute partial CE on each vocab shard; psum scalars instead of "
     "gathering (B,S,V) logits"),
]


def run_cell(arch, shape, sets, tag, out="experiments/hillclimb_torch",
             timeout=900):
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out, "--tag", tag]
    for s in sets:
        cmd += ["--set", s]
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    subprocess.run(cmd, capture_output=True, timeout=timeout, env=env)
    path = f"{out}/{arch}__{shape}__16x16__{tag}.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def dominant_term(rec):
    return {"compute": rec["t_compute_s"], "memory": rec["t_memory_s"],
            "collective": rec["t_collective_s"]}[rec["dominant"]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    base = run_cell(args.arch, args.shape, [], "hc_base")
    if not base or not base.get("ok"):
        sys.exit(f"baseline failed: {base and base.get('error')}")
    applied: list = []
    print(f"baseline: dominant={base['dominant']} "
          f"t={dominant_term(base):.3f}s frac={base['roofline_fraction']:.3f}")
    stale = 0
    for rnd in range(args.rounds):
        if stale >= 3:
            print("stopping: 3 consecutive <5% improvements")
            break
        best = None
        for i, (sets, term, hyp) in enumerate(CANDIDATES):
            if any(s in applied for s in sets):
                continue
            if term != base["dominant"] and base["roofline_fraction"] < 0.9:
                continue  # attack the dominant term first
            rec = run_cell(args.arch, args.shape, applied + sets,
                           f"hc_r{rnd}_c{i}")
            if not rec or not rec.get("ok"):
                print(f"  [{'+'.join(sets)}] FAILED to trace — refuted")
                continue
            t_new = dominant_term(base)
            t_after = {"compute": rec["t_compute_s"],
                       "memory": rec["t_memory_s"],
                       "collective": rec["t_collective_s"]}[base["dominant"]]
            gain = 1 - t_after / t_new
            verdict = "CONFIRMED" if gain > 0.05 else "refuted(<5%)"
            print(f"  [{'+'.join(sets)}] {hyp[:60]}... "
                  f"{base['dominant']} {t_new:.3f}->{t_after:.3f}s "
                  f"({gain * 100:+.0f}%) {verdict}")
            if gain > 0.05 and (best is None or gain > best[0]):
                best = (gain, sets, rec)
        if best is None:
            stale += 1
            continue
        stale = 0
        applied += best[1]
        base = best[2]
        print(f"round {rnd}: applied {best[1]} -> dominant={base['dominant']} "
              f"frac={base['roofline_fraction']:.3f}")
    print(f"final: overrides={applied} frac={base['roofline_fraction']:.3f} "
          f"dominant={base['dominant']}")


if __name__ == "__main__":
    main()
