"""The LM training traffic: back-to-back training steps of one model on
token batches made from the seed.

Set-up draws the weights and a pool of distinct token batches on the
device (``bench/lm_inputs.py``), builds the program's training step
(``launch/steps.py::make_train_step`` with no mesh, the configuration's
AdamW) and drives that same step object through its first
``reference_steps`` steps on the pool's first batches, which warms every
shape; after the first it reads each leaf's first gradient as the
optimizer got it (|m| / (1 - b1)), after the last each leaf's change from
the initial weights (drawn again leaf by leaf). The window runs further
steps, each ending in ``torch.cuda.synchronize()``, until ``seconds`` have
passed; ``train_tokens_per_s`` is the tokens of the window's steps over
its wall time.

``correct``: once the window has closed and the program's state is freed,
the plain reference (``reference/qwen2.py``) trains the same initial
weights on the same batches for the same steps, and four numbers are
compared, each against its limit in the configuration file:
``loss_gap``, the largest relative gap of a step's loss; ``grad_norm_gap``
and ``change_gap``, over the leaves, the largest gap between the
program's and the reference's norm of a leaf's first gradient, or of its
change over the steps, relative to the larger of the reference's norm of
that leaf and the median leaf's; ``grad_norm_gap_mean``, the first
gradient's gap averaged over the leaves (the worst leaf's swings with the
rounding of one small leaf, the value bias; the mean separates the
program from the float8 control). A leaf whose reference gradient is below
a thousandth of the median leaf's (a key bias under softmax) moves by
round-off alone and is left out of both.

Traced: ``trace_steps`` steps of the window under the profiler.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch
from torch.profiler import record_function

from portbench.bench import lm_inputs
from portbench.bench import trace as trace_mod
from portbench.bench import work
from portbench.bench.harness import Outcome
from portbench.reference import qwen2

SLICE = 1 << 26
EXCLUDE_BELOW = 1e-3


def program_config(c: dict):
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    return ModelConfig(
        name=c["name"], family="dense",
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        qkv_bias=True, rope_theta=float(c["rope_theta"]),
        norm_eps=c["rms_norm_eps"], tie_embeddings=c["tie_word_embeddings"],
        dtype=c["torch_dtype"], mlp_gated=c["hidden_act"] == "silu",
        parallel=ParallelConfig(remat=c["remat"],
                                opt_state_dtype=c["optimizer"]
                                ["state_dtype"]),
        attention_impl="fused")


def reference_config(c: dict) -> dict:
    return {"head_dim": c["hidden_size"] // c["num_attention_heads"],
            "num_heads": c["num_attention_heads"],
            "num_kv_heads": c["num_key_value_heads"],
            "norm_eps": c["rms_norm_eps"], "rope_theta": c["rope_theta"]}


def _norm(x) -> torch.Tensor:
    """The float32 norm of a tensor, summed a slice at a time (on its
    device; no host wait)."""
    flat = x.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, flat.numel(), SLICE):
        total = total + torch.sum(torch.square(flat[i:i + SLICE].float()))
    return torch.sqrt(total)


def _change(p, spec, index, seed, dtype) -> torch.Tensor:
    """|p - p0| of one leaf, p0 drawn again from the seed."""
    p0 = lm_inputs.make_leaf(spec, index, seed, dtype, p.device)
    flat, flat0 = p.detach().reshape(-1), p0.reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=p.device)
    for i in range(0, flat.numel(), SLICE):
        total = total + torch.sum(torch.square(
            flat[i:i + SLICE].float() - flat0[i:i + SLICE].float()))
    return torch.sqrt(total)


def leaf_list(tree):
    return [x for _, x in qwen2.leaves(tree)]


def run(r) -> Outcome:
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
    dev, c, t = r.device, r.config, r.traffic
    seed = r.seed
    opt_d = c["optimizer"]
    dtype = getattr(torch, c["torch_dtype"])
    specs = lm_inputs.leaf_specs(c)
    b, s = c["global_batch"], t["seq_len"]
    if dev.type == "cuda":
        _build.library()
    cfg = program_config(c)
    api = build_model(cfg)
    opt_cfg = OptimizerConfig(**opt_d)
    params = lm_inputs.make_params(c, seed, dev)
    tokens = lm_inputs.make_tokens(c["vocab_size"], seed, t["token_pool"], b,
                                   s, dev)
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(api, None, opt_cfg)

    def batch(i):
        return {"tokens": tokens[i % t["token_pool"]]}

    # the first steps: warm-up, and the readings the reference follows
    n_ref = t["reference_steps"]
    losses, grad_norms = [], None
    for i in range(n_ref):
        params, opt, m = step(params, opt, batch(i))
        losses.append(m["loss"].detach().float())
        if i == 0:
            grad_norms = [_norm(x) / (1.0 - opt_cfg.b1)
                          for x in leaf_list(opt["m"])]
    changes = [_change(p, spec, i, seed, dtype) for i, (spec, p) in
               enumerate(zip(specs, leaf_list(params)))]
    prog = {"loss": torch.stack(losses).cpu().tolist(),
            "grad": torch.stack(grad_norms).cpu().tolist(),
            "change": torch.stack(changes).cpu().tolist()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    r.setup_done()

    units, i = 0, n_ref
    traced = {}
    if r.trace:
        with trace_mod.profiled(traced):
            with record_function(trace_mod.WINDOW):
                for _ in range(t["trace_steps"]):
                    params, opt, m = step(params, opt, batch(i))
                    _sync(dev)
                    i, units = i + 1, units + 1
        elapsed = None
    else:
        t0 = time.perf_counter()
        while True:
            params, opt, m = step(params, opt, batch(i))
            _sync(dev)
            i, units = i + 1, units + 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    del params, opt, m, step, api
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_readings(c, seed, tokens[:n_ref], dev, "float32")
    checks = compare(prog, want, c["limits"])
    if getattr(r, "control", False):
        ctrl = reference_readings(c, seed, tokens[:n_ref], dev, "fp8")
        r.control_checks = compare(ctrl, want, c["limits"])
        r.readings = {"program": prog, "reference": want, "control": ctrl}
    else:
        r.readings = {"program": prog, "reference": want}
    out = Outcome(attempted=units, failed=0,
                  end_to_end={} if elapsed is None else
                  {"train_tokens_per_s": units * b * s / elapsed},
                  checks=checks, memory_peak_bytes=peak, units=units)
    if r.trace:
        out.trace = traced["trace"]
        out.work = step_work(c, b, s, specs)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_readings(c, seed, batches, dev, precision) -> dict:
    """The reference's losses, first-gradient norms and changes."""
    specs = lm_inputs.leaf_specs(c)
    dtype = getattr(torch, c["torch_dtype"])
    params = lm_inputs.make_params(c, seed, dev)
    opt = dict(c["optimizer"])
    got = {}

    def on_step(i, p, state):
        if i == 0:
            got["grad"] = [float(_norm(x)) / (1.0 - opt["b1"])
                           for x in leaf_list(state["m"])]
        if i == len(batches) - 1:
            got["change"] = [float(_change(x, spec, j, seed, dtype))
                             for j, (spec, x) in
                             enumerate(zip(specs, leaf_list(p)))]

    got["loss"] = qwen2.train(params, list(batches), reference_config(c), opt,
                              precision=precision, on_step=on_step)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return got


def _leaf_gaps(got, want, keep) -> list:
    floor = statistics.median(w for w, k in zip(want, keep) if k)
    return [abs(g - w) / max(w, floor)
            for g, w, k in zip(got, want, keep) if k]


def compare(got: dict, want: dict, limits: dict) -> dict:
    med = statistics.median(want["grad"])
    keep = [w >= EXCLUDE_BELOW * med for w in want["grad"]]
    grad = _leaf_gaps(got["grad"], want["grad"], keep)
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got["loss"],
                                                       want["loss"]))
    out = {"loss_gap": loss_gap, "grad_norm_gap": max(grad),
           "grad_norm_gap_mean": statistics.mean(grad),
           "change_gap": max(_leaf_gaps(got["change"], want["change"],
                                        keep))}
    return {k: (v, limits[k]) for k, v in out.items()}


def step_work(c, b, s, specs) -> dict:
    """Model flops of a step and K9's bounds a call, from the shapes."""
    hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["hidden_size"] // hq
    n_params = sum(math.prod(sp[1]) for sp in specs
                   if sp[0] != ("embed", "table"))
    return {"model_flops_per_step": work.train_step_flops(
                n_params, b * s, b, s, hq, hd, c["num_hidden_layers"]),
            "k9_fwd": work.k9_forward(b, hq, hkv, s, hd),
            "k9_bwd": work.k9_backward(b, hq, hkv, s, hd),
            "layers": c["num_hidden_layers"]}

