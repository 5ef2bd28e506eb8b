"""Training driver: config -> data -> fault-tolerant loop, on one device.

The port of the JAX package's ``repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
      --steps 100 --ckpt build/train_run --device cpu

``--smoke`` selects the reduced config (CPU-runnable); without it the full
config trains on the card. Resumes from the latest checkpoint in ``--ckpt``
automatically. Runs on the card unless ``--device`` names another.
``--mesh DATAxMODEL`` (``1x2``, ``2x2``, ...) trains on that mesh, every
rank in this process on the one device (``launch/mesh.py``): the params
and the optimizer state sharded by the rules (``parallel/sharding.py``),
the checkpoints whole arrays, as one device's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step, opt_config_for
from repro_torch.models import build_model
from repro_torch.optim.optimizer import init_opt_state
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainingRunner


def build_everything(cfg, mesh, global_batch, seq_len, seed=0, steps=1000,
                     device=None):
    """(api, params, opt_state, step, data) for ``cfg`` on ``device`` (the
    card when None): params from ``seed``, the optimizer of
    ``opt_config_for``, the train step, and the token pipeline of ``seed``.
    On a ``mesh`` the params are sharded by the rules (``Sharded`` leaves,
    each rank a copy of its blocks) and the pipeline gives the whole batch
    (each rank slices its rows)."""
    dev = resolve_device(device)
    api = build_model(cfg)
    params = api.init(seed, device=dev)
    if mesh is not None:
        params = shd.shard_params(params, mesh, layout=cfg.parallel.layout)
    opt_cfg = opt_config_for(cfg, steps=steps)
    opt_state = init_opt_state(params, opt_cfg)
    step = make_train_step(api, mesh, opt_cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    data = TokenPipeline(dcfg, device=dev)
    return api, params, opt_state, step, data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 1x2")
    ap.add_argument("--ckpt", default="build/repro_torch_ckpt")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    da, mo = (int(x) for x in args.mesh.split("x"))
    mesh = None if da * mo == 1 else make_mesh((da, mo), ("data", "model"))
    dev = resolve_device(args.device)
    api, params, opt, step, data = build_everything(
        cfg, mesh, args.batch, args.seq, device=dev)

    runner = TrainingRunner(
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 10)),
        step, params, opt, data)
    if runner.try_resume():
        print(f"resumed from step {runner.step}")

    t0 = time.time()
    n0 = runner.step
    status = runner.run(args.steps)
    dt = time.time() - t0
    losses = runner.history
    for i in range(args.log_every - 1, len(losses), args.log_every):
        print(f"step {n0 + i + 1} loss {losses[i]:.4f}")
    print(f"status={status} steps={runner.step - n0} "
          f"wall={dt:.1f}s ({dt / max(runner.step - n0, 1):.3f}s/step)")
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"loss first10={np.mean(losses[:k]):.4f} "
              f"last10={np.mean(losses[-k:]):.4f}")
    data.close()
    return runner


if __name__ == "__main__":
    main()
