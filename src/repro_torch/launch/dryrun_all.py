"""Drive the full dry-run matrix: every (arch x shape) cell on both production
meshes, one subprocess per cell (resumable via existing JSON files).

The port of the JAX package's ``repro/launch/dryrun_all.py`` over
``python -m repro_torch.launch.dryrun``. The LM cells trace on ``meta`` and
touch no device; ``--jobs`` runs that many cells at once.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--force] \\
      [--timeout 1800] [--jobs 4]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all --only qwen2-7b
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b", "qwen2-7b", "starcoder2-15b",
         "qwen3-14b", "chatglm3-6b", "whisper-base", "llava-next-34b",
         "xlstm-125m", "recurrentgemma-2b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def run_cell(arch, shape, multi_pod, out, timeout, force=False, sets=(),
             tag=""):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    tagsfx = f"__{tag}" if tag else ""
    path = f"{out}/{arch}__{shape}__{mesh_tag}{tagsfx}.json"
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("ok"):
            return rec, "cached"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    for s in sets:
        cmd += ["--set", s]
    if tag:
        cmd += ["--tag", tag]
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        status = "ok" if proc.returncode == 0 else "fail"
    except subprocess.TimeoutExpired:
        status = "timeout"
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape, "multi_pod": multi_pod,
                       "ok": False, "error": f"timeout>{timeout}s"}, f)
    rec = None
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    return rec, f"{status} ({time.time()-t0:.0f}s)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--only", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    pods = [False] if args.single_pod_only else [False, True]
    cells = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in pods
             if args.only is None or args.only == a]
    t0 = time.time()
    n_ok = n_fail = 0
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        futs = [pool.submit(run_cell, arch, shape, mp, args.out,
                            args.timeout, args.force)
                for arch, shape, mp in cells]
        for i, ((arch, shape, mp), fut) in enumerate(zip(cells, futs)):
            rec, status = fut.result()
            ok = bool(rec and rec.get("ok"))
            n_ok += ok
            n_fail += not ok
            dom = rec.get("dominant", "-") if rec else "-"
            frac = rec.get("roofline_fraction") if rec else None
            frac = f"{frac:.3f}" if isinstance(frac, float) else "-"
            skip = " SKIP" if rec and rec.get("skipped") else ""
            print(f"[{i+1}/{len(cells)}] {arch:22s} {shape:12s} "
                  f"{'2x16x16' if mp else '16x16':8s} {status:12s} "
                  f"dom={dom:10s} frac={frac}{skip}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed, {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
