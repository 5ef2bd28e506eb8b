"""Mixture-of-Experts: top-k routing, capacity, and the local dispatch.

The port of the JAX package's ``repro/models/moe.py`` for one device. The
JAX module's strategies map the paper's two patterns onto expert
parallelism (``move_data``: all-gather the expert weights to every shard;
``move_compute``: all_to_all the tokens to the expert's owner), and
``auto`` picks the one that moves fewer bytes (``moe_strategy_cost``).
Without a mesh every strategy runs ``moe_local``, as the JAX
``apply_moe`` does. On a mesh (``mesh``: a rank's ``dist.MeshComm``, the
expert weights its blocks, E over ``model``) each rank runs the JAX
``shard_map`` body on its tokens: ``moe_move_data`` gathers every expert
whole and routes locally; ``moe_move_compute`` sends each token to the
rank that owns its expert with one ``all_to_all``, computes there, and
sends the results back with another, no weight crossing the ``model``
axis. Under the ``tp`` layout a rank's tokens are split further over
``model`` (``split_model``) and gathered back after; the aux loss is
averaged over every axis. ``local`` on a mesh routes the whole batch's
tokens (gathered over the batch axes), as GSPMD runs JAX's ``moe_local``
on the global array.

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

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_mlp, dtype_of, gelu, init_mlp,
                                       normal)
from repro_torch.parallel import sharding as shd

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


# ------------------------------------------------------------ sharded engines
def _scatter_rows(buf_shape, rows, idx0, idx1):
    """A zero (N0, N1, ...) buffer with ``rows`` written at (idx0, idx1):
    an index N1 lands in a spare row, sliced off (JAX's ``mode="drop"``)."""
    buf = torch.zeros(buf_shape[:1] + (buf_shape[1] + 1,) + buf_shape[2:],
                      dtype=rows.dtype, device=rows.device)
    buf[idx0, idx1] = rows
    return buf[:, :buf_shape[1]]


def _gather_rows(buf, idx0, idx1):
    """buf[idx0, idx1], the spare index reading 0 (JAX's ``mode="fill"``)."""
    return F.pad(buf, (0, 0) * (buf.dim() - 2) + (0, 1))[idx0, idx1]


def moe_move_data(p, cfg: ModelConfig, x2d, *, mesh, model_axis="model",
                  data_axes=("data",)):
    """Paper's OLD pattern on a rank: all-gather the expert weights to
    every rank (download the data), then compute locally."""
    del model_axis, data_axes           # every axis of the blocks gathered
    w = {k: shd.whole(p[k], mesh) if k in p else None
         for k in ("router", "w_gate", "w_up", "w_down")}
    return moe_local(w["router"], w["w_gate"], w["w_up"], w["w_down"], cfg,
                     x2d)


def moe_move_compute(p, cfg: ModelConfig, x2d, *, mesh, model_axis="model",
                     data_axes=("data",)):
    """Paper's NEW pattern: ship tokens (requests) to the expert's owner
    rank, compute there, ship results (responses) back. Two all_to_alls, no
    weight movement across the model axis."""
    del data_axes                       # the blocks' own axes are gathered
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.top_k
    p_sz = mesh.shape[model_axis]
    e_loc = e // p_sz
    assert e % p_sz == 0, (e, p_sz)

    # local experts: this rank's E/model block, every other axis gathered
    own = shd.P(model_axis, None, None)
    w_up, w_down = shd.as_spec(p["w_up"], mesh, own), \
        shd.as_spec(p["w_down"], mesh, own)
    w_gate = shd.as_spec(p["w_gate"], mesh, own) if "w_gate" in p else None

    gates, experts, aux = topk_routing(shd.whole(p["router"], mesh), x2d, k)

    # ---- build per-peer request buffers (the 42-byte request analogue) ----
    flat_e = experts.reshape(-1).long()                   # (N=T*k,)
    peer = flat_e // e_loc                                # owning rank
    cap_p = _capacity(t, k, p_sz, cfg.capacity_factor)
    pos_p = positions_within(peer, p_sz)
    keep = pos_p < cap_p
    pos_pc = torch.where(keep, pos_p, cap_p).long()
    tok_rows = x2d[:, None, :].expand(t, k, d).reshape(t * k, d)
    send_tok = _scatter_rows((p_sz, cap_p, d), tok_rows, peer, pos_pc)
    # the local expert id a slot, -1 where empty
    send_e = _scatter_rows((p_sz, cap_p), (flat_e % e_loc + 1).to(
        torch.int32), peer, pos_pc) - 1
    recv_tok = mesh.all_to_all(send_tok, model_axis, 0, 0)
    recv_e = mesh.all_to_all(send_e, model_axis, 0, 0)

    # ---- owner-side computation (the "calculation request" handler) ----
    r_tok = recv_tok.reshape(p_sz * cap_p, d)
    r_e = recv_e.reshape(p_sz * cap_p)
    valid = r_e >= 0
    r_e_c = torch.where(valid, r_e, 0).long()
    cap_e = _capacity(p_sz * cap_p, 1, e_loc, cfg.capacity_factor)
    pos_e = positions_within(torch.where(valid, r_e_c, e_loc), e_loc + 1)
    keep_e = valid & (pos_e < cap_e)
    pos_ec = torch.where(keep_e, pos_e, cap_e).long()
    buf = _scatter_rows((e_loc, cap_e, d), r_tok, r_e_c, pos_ec)
    out_buf = _expert_ffn(w_gate, w_up, w_down, cfg, buf)
    r_out = _gather_rows(out_buf, r_e_c, pos_ec) * keep_e[:, None]

    # ---- responses travel back (the 9-byte response analogue) ----
    send_back = r_out.reshape(p_sz, cap_p, d)
    recv_back = mesh.all_to_all(send_back, model_axis, 0, 0)
    y_tok = _gather_rows(recv_back, peer, pos_pc) * keep[:, None]
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
    """x: (B, S, d) -> (y, aux). Dispatches per cfg.parallel.moe_strategy
    (without a mesh every strategy runs ``moe_local``, as in JAX)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    strategy = strategy or cfg.parallel.moe_strategy
    model_size = 1
    axis_names = ()
    if mesh is not None:
        model_size = mesh.shape.get("model", 1)
        axis_names = tuple(mesh.axis_names)
    ndev = mesh.size if mesh is not None else 1
    tok_axes = shd.batch_axes(mesh, cfg.parallel.layout) \
        if mesh is not None else ()
    rows = shd.batch_split() if mesh is not None else 1
    n_tok = b * s * rows                 # the whole batch's tokens
    if strategy == "auto":
        t_local = n_tok // max(1, ndev)
        strategy = choose_strategy(cfg, t_local, model_size) \
            if model_size > 1 else "local"
    if mesh is None or model_size <= 1 or strategy == "local":
        w = {k: shd.whole(p[k], mesh) if k in p else None
             for k in ("router", "w_gate", "w_up", "w_down")}
        x_all = mesh.all_gather(x2d, tok_axes, 0) if rows > 1 else x2d
        y, aux = moe_local(w["router"], w["w_gate"], w["w_up"], w["w_down"],
                           cfg, x_all)
        if rows > 1:
            y = shd.block(y, 0, rows, mesh.axis_index(tok_axes))
    else:
        data_axes = tuple(a for a in axis_names if a != "model")
        fn = moe_move_data if strategy == "move_data" else moe_move_compute
        # tokens additionally split over the model axis: otherwise all
        # model ranks redundantly compute identical expert FFNs. In the
        # 'fsdp' layout tokens already arrive model-split.
        split_model = ("model" not in tok_axes
                       and n_tok % ndev == 0 and model_size > 1)
        x_in = x2d
        if split_model:
            t_m = x2d.shape[0] // model_size
            x_in = x2d.narrow(0, mesh.axis_index("model") * t_m, t_m)
        with dist.comm_scope("moe"):
            y, aux = fn(p, cfg, x_in, mesh=mesh, model_axis="model",
                        data_axes=data_axes)
            if split_model:
                y = mesh.all_gather(y, "model", 0)
        for ax in mesh.axis_names:       # replicate aux across the mesh
            aux = mesh.pmean(aux, ax)
    if cfg.moe_dense_residual:
        y = y + apply_mlp(p["dense"], cfg, x2d, mesh)
    return y.reshape(b, s, d), aux
