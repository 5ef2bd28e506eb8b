#!/usr/bin/env python3
"""Where a split-KV decode step's host time goes on a mesh of ranks behind
the baton (``dist.LocalMesh``), on one card:

    python3 tools/mesh_decode_probe.py [--layers 4] [--steps 8]

moonshot-v1-16b-a3b at full width, ``--layers`` deep, B=8, a 1,024-token
prompt: the median decode step's wall ms mesh-free, and on (data 1, model
4) under ``move_compute`` and ``move_data``; beside each, the host ms of
the baton's own cost (``--calls`` tiny ``psum``s over ``model``: the
microseconds a collective), and the collectives a step. Prints one JSON
line."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main() -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--one-core", action="store_true",
                    help="pin this process's threads to one CPU core")
    args = ap.parse_args()
    if args.one_core:
        os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[0]})
    if not torch.cuda.is_available():
        print("mesh_decode_probe: needs a CUDA device", file=sys.stderr)
        return 2
    base = get_config("moonshot-v1-16b-a3b")
    cfg = base.replace(num_layers=args.layers, capacity_factor=3.0)
    dev = "cuda"
    params = build_model(cfg).init(0, device=dev)
    batch = serve_lm.make_batch(cfg, 8, 1024, dev, seed=1)
    pad = 1024 + args.steps + 1
    out = {"layers": args.layers, "steps": args.steps,
           "one_core": args.one_core}

    def timed(step_fn):
        ms = []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[len(ms) // 2]

    api = build_model(cfg)
    with torch.no_grad():
        _, st = api.prefill(params, batch, pad_cache_to=pad)
        tok = batch["tokens"][:, 0]
        holder = {"st": st}

        def free_step():
            _, holder["st"] = api.decode_step(params, holder["st"], tok)
        out["mesh_free_ms"] = timed(free_step)
    del st, holder
    mesh = make_mesh((1, 4), ("data", "model"))
    sp = shd.shard_params(params, mesh, copy=False)
    from repro_torch import dist
    counted = {"n": 0}
    real_run = dist.MeshComm._run

    def run_counted(self, *a):
        counted["n"] += 1
        return real_run(self, *a)
    dist.MeshComm._run = run_counted

    def baton(cm):
        x = torch.ones(16, device=dev)
        for _ in range(args.calls):
            x = cm.psum(x, "model") * 0.25
        return x
    mesh.run(baton, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh.run(baton, device=dev)
    torch.cuda.synchronize()
    out["us_per_collective"] = (time.perf_counter() - t0) * 1e6 / args.calls
    for strategy in ("move_compute", "move_data"):
        c = cfg.replace(parallel=cfg.parallel.replace(moe_strategy=strategy))
        sapi = build_model(c)
        with torch.no_grad():
            def pre(cm):
                with shd.use_mesh(cm):
                    return sapi.prefill(shd.local_tree(sp, cm.rank), batch,
                                        cm, pad_cache_to=pad)[1]
            states = mesh.run(pre, device=dev)

            def mesh_step():
                def one(cm):
                    with shd.use_mesh(cm):
                        return sapi.decode_step(shd.local_tree(sp, cm.rank),
                                                states[cm.rank], tok, cm)[1]
                states[:] = mesh.run(one, device=dev)
            counted["n"] = 0
            ms = timed(mesh_step)
            out[strategy] = {"step_ms": ms, "collectives_per_rank_step":
                             counted["n"] / mesh.size / args.steps}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
