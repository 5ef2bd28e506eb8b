"""Mixture-of-Experts: top-k routing, capacity, and the local dispatch.

The port of the JAX package's ``repro/models/moe.py`` for one device. The
JAX module's strategies map the paper's two patterns onto expert
parallelism (``move_data``: all-gather the expert weights to every shard;
``move_compute``: all_to_all the tokens to the expert's owner), and
``auto`` picks the one that moves fewer bytes (``moe_strategy_cost``).
Without a mesh every strategy runs ``moe_local``, as the JAX
``apply_moe`` does; with a mesh the port raises (the sharded strategies
are ROADMAP Queue 1 item 14f).

The dispatch has no host wait, so a decode step can run it: the top-k is a
stable descending sort (a tie keeps the lower expert, as
``jax.lax.top_k``), ``positions_within`` a stable sort and a
``searchsorted``, and the scatter / gather with ``mode="drop"`` /
``mode="fill"`` write and read a buffer with one spare row at index
``cap``, which is sliced off (no boolean mask, no ``nonzero``). The
per-expert products are batched matmuls (``torch.bmm``), as JAX's
``einsum("ecd,edf->ecf")`` outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (LATER, apply_mlp, dtype_of, gelu,
                                       init_mlp, normal)

F32 = torch.float32


# ------------------------------------------------------------ params
def init_moe(gen, cfg: ModelConfig, d: int, device, lead=()):
    dt = dtype_of(cfg)
    e, ff = cfg.num_experts, cfg.d_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {
        "router": normal(gen, lead + (d, e), s_in, F32, device),
        "w_up": normal(gen, lead + (e, d, ff), s_in, dt, device),
        "w_down": normal(gen, lead + (e, ff, d), s_out, dt, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = normal(gen, lead + (e, d, ff), s_in, dt, device)
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(gen, cfg, d, cfg.d_ff, device, lead)
    return p


# ------------------------------------------------------------ routing
def topk_routing(router_w, x2d, k: int):
    """x2d: (T, d) -> gates (T, k) f32 (renormalised), expert ids (T, k)
    int32, and the load-balancing aux loss (Switch-style)."""
    logits = x2d.to(F32) @ router_w                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # the k largest, a tie to the lower expert (jax.lax.top_k's order)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = top[:, :k], idx[:, :k].to(torch.int32)
    gates = gates / torch.clamp_min(torch.sum(gates, dim=-1, keepdim=True),
                                    1e-9)
    e = router_w.shape[1]
    # aux: mean prob per expert x fraction of tokens routed to expert
    frac_prob = torch.mean(probs, dim=0)
    top1 = torch.zeros(e, dtype=F32, device=x2d.device).scatter_add_(
        0, idx[:, 0], torch.ones(idx.shape[0], dtype=F32,
                                 device=x2d.device))
    frac_tok = top1 / idx.shape[0]
    aux = e * torch.sum(frac_prob * frac_tok)
    return gates, experts, aux


def positions_within(ids, num_buckets: int):
    """Rank of each element within its bucket (stable, sort-based).
    ids: (N,) integer in [0, num_buckets). Returns (N,) int32."""
    n = ids.shape[0]
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.searchsorted(
        sorted_ids, torch.arange(num_buckets, dtype=ids.dtype,
                                 device=ids.device), side="left")
    ranks = torch.arange(n, dtype=torch.int32, device=ids.device) - \
        first[sorted_ids.long()].to(torch.int32)
    out = torch.empty(n, dtype=torch.int32, device=ids.device)
    out[order] = ranks
    return out


def _capacity(n_tokens: int, k: int, buckets: int, factor: float,
              minimum=4):
    c = int(math.ceil(n_tokens * k / buckets * factor))
    return max(minimum, -(-c // 8) * 8)  # round up to 8 lanes


# ------------------------------------------------------------ local engine
def _expert_ffn(w_gate, w_up, w_down, cfg: ModelConfig, buf):
    """buf: (E, C, d) -> (E, C, d)."""
    up = torch.bmm(buf, w_up)
    if cfg.mlp_gated:
        up = F.silu(torch.bmm(buf, w_gate)) * up
    else:
        up = gelu(up)
    return torch.bmm(up, w_down)


def moe_local(p_router, w_gate, w_up, w_down, cfg: ModelConfig, x2d,
              capacity_factor=None):
    """All experts resident locally. x2d: (T, d) -> (T, d), aux."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    gates, experts, aux = topk_routing(p_router, x2d, k)
    cap = _capacity(t, k, e, cf)

    flat_e = experts.reshape(-1).long()                   # (T*k,)
    pos = positions_within(flat_e, e)
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap).long()            # cap: the spare row
    buf = torch.zeros((e, cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[flat_e, pos_c] = x2d[:, None, :].expand(t, k, d).reshape(t * k, d)
    out_buf = _expert_ffn(w_gate, w_up, w_down, cfg, buf[:, :cap])
    out_buf = F.pad(out_buf, (0, 0, 0, 1))                # the fill row: 0
    y_tok = out_buf[flat_e, pos_c] * keep[:, None]
    y = torch.sum(y_tok.reshape(t, k, d).to(F32) * gates[..., None], dim=1)
    return y.to(x2d.dtype), aux


# ------------------------------------------------------------ cost model
def moe_strategy_cost(cfg: ModelConfig, t_local: int, model_size: int,
                      bytes_per_el=2):
    """Bytes crossing the model axis per device per layer, fwd only.
    The 'auto' chooser (paper principle as a cost model) picks the min."""
    e = cfg.num_experts
    e_loc = max(1, e // max(model_size, 1))
    n_mats = 3 if cfg.mlp_gated else 2
    w_bytes = (e - e_loc) * n_mats * cfg.d_model * cfg.d_ff * bytes_per_el
    frac_remote = (model_size - 1) / max(model_size, 1)
    tok_bytes = 2 * t_local * cfg.top_k * cfg.d_model * bytes_per_el * \
        frac_remote
    return {"move_data": w_bytes, "move_compute": tok_bytes}


def choose_strategy(cfg: ModelConfig, t_local: int, model_size: int) -> str:
    c = moe_strategy_cost(cfg, t_local, model_size)
    return "move_data" if c["move_data"] < c["move_compute"] else \
        "move_compute"


# ------------------------------------------------------------ entry point
def apply_moe(p, cfg: ModelConfig, x, *, mesh=None, strategy=None):
    """x: (B, S, d) -> (y, aux). Without a mesh every strategy runs
    ``moe_local`` (JAX's ``apply_moe`` does the same); a mesh raises."""
    b, s, d = x.shape
    strategy = strategy or cfg.parallel.moe_strategy
    if mesh is not None:
        raise NotImplementedError(
            f"the MoE strategy {strategy!r} on a mesh is {LATER['mesh']}")
    x2d = x.reshape(b * s, d)
    y, aux = moe_local(p["router"], p.get("w_gate"), p["w_up"], p["w_down"],
                       cfg, x2d)
    if cfg.moe_dense_residual:
        y = y + apply_mlp(p["dense"], cfg, x2d)
    return y.reshape(b, s, d), aux
