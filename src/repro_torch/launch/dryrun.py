"""The dry run: one (arch x shape) cell traced on the production mesh, its
per-device counts and its roofline on H100 terms.

The port of the JAX package's ``repro/launch/dryrun.py``. JAX lowers and
compiles the step for 512 placeholder devices and parses the HLO; here one
rank's step runs on ``meta`` tensors under a ``dist.ShapeMesh`` of the
production shape (16x16, or 2x16x16 with ``--multi-pod``), whose
collectives only compute shapes, inside ``roofline.StepCounter``. Only that
rank's blocks of the params, the optimizer state and the decode state are
built (``shard_params`` over ``mesh.ranks``, one rank; a ``meta`` copy
allocates nothing, and gives the rank's leaves their own storage):
the ranks of an SPMD step run the same ops on blocks of the same shapes,
so one rank's counts are a device's. The LM cells touch no device. On
``meta`` the attention runs its ``reference`` lowering (K9 cannot run
there), the plain chunked softmax whose products the counter sees, and the
xLSTM's scans trace one step counted as all (``dist.repeated``).

``lower_brain_cell`` runs one chunk of rank 0 of R (R = 256 or 512) at
``brain_64k`` (``CONFIG``'s 65,536 neurons a rank) through
``dist.LoneComm`` on the card (``--device cpu`` otherwise), every lowering
fused: one warm-up chunk under the counter, one counted and timed chunk;
their collective records must be equal.

The record keeps JAX's keys where they mean the same: ``collectives``
(wire bytes by kind), ``collective_logical``, ``collective_bytes_per_dev``,
``model_flops_global``, ``model_flops_per_dev``, ``useful_flops_ratio``,
``mem_bytes_per_dev`` (the analytic memory term, JAX's), ``param_bytes_per_dev``
and the terms (``t_compute_s``, ``t_memory_s``, ``t_collective_s``,
``dominant``, ``roofline_fraction``). Keys that name XLA in JAX's get the
port's names: ``dot_flops_per_dev`` for ``hlo_dot_flops_per_dev``,
``trace_s`` for ``lower_s`` / ``compile_s``, ``ops`` (aten ops counted) for
``hlo_bytes``. ``memory_analysis`` holds the trace's argument, output and
temp (the peak of what the step allocated, alive at once) bytes, and the
rank's own param and (training) optimizer-state bytes: m and v are split
by the optimizer-state rule, as JAX's dry run shards them (the params' plus
``pod`` on the fsdp dim: ZeRO across pods, ``optim/optimizer.py``), so at
2x16x16 a leaf whose fsdp dim splits holds half the params' block. The port
adds ``collective_wire_bytes_by_link`` (NVLink inside a node of 8 ranks,
InfiniBand across), ``collective_arriving`` (``Mesh.bytes``' count by
``"scope:kind"``), ``collective_count``, ``materialized_bytes`` and
``hw``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch] \\
      [--set moe_strategy=move_data ...] [--tag T]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch msp-brain \\
      --shape brain_64k [--set connectivity_alg=old] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch import dist
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import supports_long_context
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, opt_config_for)
from repro_torch.models import build_model, decode_state_specs, input_specs
from repro_torch.models import param_specs
from repro_torch.models.decode import state_shardings
from repro_torch.optim.optimizer import (init_opt_state, leaves,
                                         shard_opt_state)
from repro_torch.parallel import sharding as shd


def _apply_overrides(cfg, sets):
    par_fields = {f.name for f in dataclasses.fields(cfg.parallel)}
    cfg_fields = {f.name for f in dataclasses.fields(cfg)}
    for kv in sets or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if k in par_fields:
            cfg = cfg.replace(parallel=cfg.parallel.replace(**{k: v}))
        elif k in cfg_fields:
            cfg = cfg.replace(**{k: v})
        else:
            raise KeyError(k)
    return cfg


def analytic_flops(cfg, shape):
    """MODEL_FLOPS: 6*N*D (train, dense) / 6*N_active*D (MoE); 2*N*D fwd-only."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        d_tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * d_tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # decode: one token per sequence


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def _tensors(tree):
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def analytic_memory(cfg, shape, ndev, params, opt=None, state=None):
    """JAX's analytic HBM traffic a device and step (``dryrun.py``; model
    in EXPERIMENTS.md §Roofline): train = 4 params + 2 opt + 12 act,
    prefill = params + 6 act, decode = params + 2 decode state; each tree's
    global bytes over the device count. Returns (mem, param bytes)."""
    pbytes = tree_bytes(params) / ndev
    tok_dev = shape.global_batch * shape.seq_len / ndev
    act = tok_dev * cfg.d_model * 2 * cfg.num_layers
    if shape.kind == "train":
        obytes = tree_bytes(opt) / ndev
        return 4 * pbytes + 2 * obytes + 12 * act, pbytes
    if shape.kind == "prefill":
        return pbytes + 6 * act, pbytes
    return pbytes + 2 * tree_bytes(state) / ndev, pbytes


def skip_reason(cfg, shape):
    """JAX's skip list: ``long_500k`` for full-attention archs."""
    if shape.name == "long_500k" and not supports_long_context(cfg):
        return "full-attention arch: quadratic over 512k (see DESIGN.md §4)"
    return None


def _batch_block_bytes(batch, mesh, layout) -> int:
    """The rank's rows of the whole batch (it slices them where the batch
    axes divide the batch)."""
    n = mesh.axis_size(shd.batch_axes(mesh, layout))
    return sum(x.numel() * x.element_size() // (n if x.shape[0] % n == 0
                                                 else 1)
               for x in batch.values())


def trace_cell(cfg, shape, mesh_shape, axes, rank: int = 0):
    """One rank's step of ``shape.kind`` on a ``ShapeMesh``: (mesh, counter,
    memory_analysis, trees) with the trees' global ``meta`` params, opt
    state and decode state (those the kind uses)."""
    mesh = dist.ShapeMesh(mesh_shape, axes, rank=rank)
    api = build_model(cfg)
    specs = input_specs(cfg, shape)
    layout = cfg.parallel.layout
    params = param_specs(cfg)
    sp = shd.shard_params(params, mesh, layout=layout)
    local = shd.local_tree(sp, rank)
    counter = rl.StepCounter()
    trees = {"params": params}
    if shape.kind == "train":
        ocfg = opt_config_for(cfg)
        trees["opt"] = init_opt_state(params, ocfg)
        # m and v as JAX's dry run shards them: ZeRO across pods
        opt = shard_opt_state(trees["opt"], mesh, layout)
        step = make_train_step(api, mesh, ocfg)
        lopt = _tensors(shd.local_tree(opt, rank))
        mem_opt = _unique_bytes(lopt)
        arg_bytes = _unique_bytes(_tensors(local) + lopt) + \
            _batch_block_bytes(specs, mesh, layout)
        with counter:
            out = step(sp, opt, specs)
        outs = _tensors(shd.local_tree(out[0], rank)) + _tensors(
            shd.local_tree(out[1], rank)) + _tensors(out[2])
    elif shape.kind == "prefill":
        step = make_prefill_step(api, mesh)
        arg_bytes = _unique_bytes(_tensors(local)) + _batch_block_bytes(
            specs, mesh, layout)
        with counter:
            out = step(sp, specs)
        outs = [out[0]] + _tensors(out[1])
    else:
        state = decode_state_specs(cfg, shape)
        trees["state"] = state
        comm = mesh.comm(rank)
        if cfg.family == "audio":
            # the encoder-decoder runs whole on every rank (``encdec.py``
            # gathers its params): its state is the whole batch's
            lstate = state
        else:
            with shd.use_mesh(comm, layout):
                sspecs = state_shardings(cfg, state, comm,
                                         shape.global_batch)
            lstate = shd.local_tree(shd.shard_params(state, mesh,
                                                     specs=sspecs), rank)
        step = make_decode_step(api, mesh)
        arg_bytes = _unique_bytes(_tensors(local) + _tensors(lstate)) + \
            _batch_block_bytes(specs, mesh, layout)
        with counter:
            out = step(sp, [lstate], specs["tokens"])
        outs = [out[0]] + _tensors(out[1])
    mem = {"argument_size_in_bytes": arg_bytes,
           "param_bytes": _unique_bytes(_tensors(local)),
           "output_size_in_bytes": _unique_bytes(outs),
           "temp_size_in_bytes": counter.peak_bytes,
           "peak_bytes": arg_bytes + counter.peak_bytes}
    if shape.kind == "train":
        mem["opt_state_bytes"] = mem_opt
    return mesh, counter, mem, trees


def lower_cell(arch, shape_name, multi_pod, sets=None):
    if arch == "msp-brain":
        return lower_brain_cell(shape_name, multi_pod, sets)
    cfg = _apply_overrides(get_config(arch), sets)
    shape = get_shape(shape_name)
    mesh_shape, axes = make_production_mesh(multi_pod=multi_pod)
    ndev = math.prod(mesh_shape)
    record = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(str(s) for s in mesh_shape),
              "multi_pod": multi_pod, "kind": shape.kind,
              "overrides": sets or [], "ok": False}
    reason = skip_reason(cfg, shape)
    if reason:
        record.update(ok=True, skipped=True, reason=reason)
        return record
    t0 = time.time()
    mesh, counter, mem, trees = trace_cell(cfg, shape, mesh_shape, axes)
    t_trace = time.time() - t0
    ana = rl.analyze(mesh.records, counter)
    mf = analytic_flops(cfg, shape)
    flops_dev = ana["dot_flops"]
    mem_bytes_dev, pbytes = analytic_memory(
        cfg, shape, ndev, trees["params"], trees.get("opt"),
        trees.get("state"))
    terms = rl.roofline_terms(flops_dev, mem_bytes_dev,
                              ana["collective_wire_bytes_by_link"])
    record.update(
        ok=True, trace_s=round(t_trace, 2), memory_analysis=mem,
        ops=ana["ops"],
        collectives=ana["collective_wire_bytes"],
        collective_logical=ana["collective_logical_bytes"],
        collective_bytes_per_dev=ana["collective_bytes_total"],
        collective_wire_bytes_by_link=ana["collective_wire_bytes_by_link"],
        collective_arriving={f"{sc or 'other'}:{k}": v
                             for (sc, k), v in mesh.bytes.items()},
        collective_count=ana["collective_count"],
        materialized_bytes=ana["materialized_bytes"],
        dot_flops_per_dev=flops_dev,
        model_flops_global=mf,
        model_flops_per_dev=mf / ndev,
        useful_flops_ratio=(mf / ndev) / max(flops_dev, 1.0),
        mem_bytes_per_dev=mem_bytes_dev,
        param_bytes_per_dev=pbytes,
        hw=rl.HW["name"],
        **terms,
    )
    return record


BRAIN_FUSED = {"activity_impl": "fused", "connectivity_impl": "fused",
               "tree_impl": "fused", "apply_impl": "fused"}


def brain_config(shape_name, sets=None):
    """``CONFIG`` at the shape's neurons a rank (``brain_64k``: 65,536),
    every lowering fused, then the ``--set`` overrides (``spike_alg=old``
    runs the reference activity lowering, as the comparison cell does)."""
    from repro_torch.configs.msp_brain import CONFIG as BRAIN
    n_per = int(shape_name.split("_")[-1].replace("k", "")) * 1024 \
        if "_" in shape_name else BRAIN.neurons_per_rank
    over = dict(BRAIN_FUSED, neurons_per_rank=n_per)
    for kv in sets or []:
        k, v = kv.split("=", 1)
        over[k] = int(v) if v.isdigit() else v
    if over.get("spike_alg") == "old" and not any(
            kv.startswith("activity_impl=") for kv in sets or []):
        over["activity_impl"] = "reference"
    return dataclasses.replace(BRAIN, **over)


def brain_chunks(cfg, num_ranks: int, device=None):
    """Rank 0 of ``num_ranks`` through ``LoneComm``: one warm-up chunk under
    ``StepCounter`` and one counted chunk, timed (host ms; on the card also
    CUDA events). Returns (comm, counter, records of each chunk, timing)."""
    from repro_torch.sim.api import Simulator
    comm = dist.LoneComm(num_ranks, 0)
    sim = Simulator.from_config(cfg, comm=comm, device=device)
    sim.state                                       # init outside the counts
    cuda = sim.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    comm.records.clear()
    counter = rl.StepCounter()
    with counter:
        sim.run(1)
    warm = list(comm.records)
    comm.records.clear()
    if cuda:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    sim.run(1)
    if cuda:
        ev[1].record()
    torch.cuda.synchronize() if cuda else None
    timing = {"chunk_ms": (time.perf_counter() - t0) * 1e3}
    if cuda:
        timing["device_ms"] = ev[0].elapsed_time(ev[1])
    return comm, counter, warm, list(comm.records), timing


def lower_brain_cell(shape_name, multi_pod, sets=None, device=None):
    """The paper's own workload as a dry-run row: rank 0 of R = every
    device of the production mesh, one chunk (``brain_chunks``)."""
    mesh_shape, _ = make_production_mesh(multi_pod=multi_pod)
    ndev = math.prod(mesh_shape)
    cfg = brain_config(shape_name, sets)
    t0 = time.time()
    comm, counter, warm, recs, timing = brain_chunks(cfg, ndev, device)
    t_trace = time.time() - t0
    if warm != recs:
        raise RuntimeError(f"brain: the warm-up chunk's {len(warm)} "
                           f"collectives differ from the counted chunk's "
                           f"{len(recs)}")
    ana = rl.analyze(recs, counter)
    terms = rl.roofline_terms(ana["dot_flops"], max(ana["dot_flops"], 1.0),
                              ana["collective_wire_bytes_by_link"])
    return {"arch": "msp-brain", "shape": shape_name, "multi_pod": multi_pod,
            "mesh": "x".join(str(s) for s in mesh_shape),
            "kind": "brain", "ok": True, "overrides": sets or [],
            "num_ranks": ndev, "neurons_per_rank": cfg.neurons_per_rank,
            "trace_s": round(t_trace, 2), **timing,
            "collectives": ana["collective_wire_bytes"],
            "collective_logical": ana["collective_logical_bytes"],
            "collective_bytes_per_dev": ana["collective_bytes_total"],
            "collective_wire_bytes_by_link":
                ana["collective_wire_bytes_by_link"],
            "collective_arriving": ana["collective_arriving_bytes"],
            "collective_count": ana["collective_count"],
            "dot_flops_per_dev": ana["dot_flops"], "hw": rl.HW["name"],
            **terms}


def out_path(out, arch, shape, multi_pod, tag=""):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    tag = f"__{tag}" if tag else ""
    return f"{out}/{arch}__{shape}__{mesh_tag}{tag}.json"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (model or parallel field)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default=None,
                    help="the brain row's device (the card when omitted)")
    args = ap.parse_args()

    try:
        if args.arch == "msp-brain":
            rec = lower_brain_cell(args.shape, args.multi_pod, args.set,
                                   device=args.device)
        else:
            rec = lower_cell(args.arch, args.shape, args.multi_pod, args.set)
    except Exception as e:
        rec = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multi_pod, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:],
               "overrides": args.set}
    os.makedirs(args.out, exist_ok=True)
    with open(out_path(args.out, args.arch, args.shape, args.multi_pod,
                       args.tag), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("traceback", "memory_analysis")},
                     indent=1, default=str))
    sys.exit(0 if rec.get("ok") else 1)


if __name__ == "__main__":
    main()
