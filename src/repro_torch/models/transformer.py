"""Decoder-only LM assembled from blocks (attn / moe / mlstm / slstm /
rglru), full-sequence form.

The port of the JAX package's ``repro/models/transformer.py``. Uniform
attention configs keep JAX's stacked layout (``layers_stacked``: every leaf
with a leading L axis, the MoE leaves too) and loop over it in Python;
heterogeneous patterns keep a list (``layers``).

Under a mesh (``mesh``: a rank's ``dist.MeshComm``; the weights its blocks,
``parallel/sharding.py``) the batch is sliced where the tokens enter
(``constrain``), and the ``tp`` layout's attention is column-parallel where
``wq`` holds its ``model`` block of the heads: each rank its H/model query
heads and their KV heads (a KV weight whose heads do not split is gathered
and its rank's head taken), K9 on the rank's heads, ``wo`` row-parallel with
a ``psum`` over ``model``; elsewhere (a replicated ``wq``, the ``fsdp``
layout, heads that do not split) the weights are gathered whole. The MLP
and the MoE partition as ``layers.apply_mlp`` and ``moe.apply_moe`` do; the
recurrent blocks run on their weights gathered. ``forward`` then returns
this rank's rows of the logits. ``vocab_parallel_cross_entropy`` is the JAX
module's move-compute loss: each rank its block of the vocab, only (B, S)
statistics cross the ``model`` axis.

Training: ``forward`` indexes the stacked tree once (``unstack``: one
``torch.unbind`` a leaf), so its backward stacks the layers' gradients once
instead of adding a zero-filled (L, ...) gradient per layer; and wraps each
layer in ``_remat`` (``cfg.parallel.remat``) when a gradient is wanted.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope,
                                       dtype_of, embed_tokens, head_weight,
                                       init_embedding, init_lm_head,
                                       init_mlp, init_norm, lm_logits,
                                       model_size, normal, ones,
                                       sinusoidal_positions,
                                       tensor_parallel, zeros)
from repro_torch.parallel import sharding as shd

F32 = torch.float32


def stacked(cfg: ModelConfig) -> bool:
    """Uniform attention configs keep their layers stacked (JAX's scan)."""
    pattern = cfg.pattern()
    return cfg.scan_layers and set(pattern) == {"attn"}


# ================================================================ init
def init_attn_weights(gen, cfg: ModelConfig, d: int, device, lead=()):
    dt = dtype_of(cfg)
    s = d ** -0.5
    so = cfg.q_dim ** -0.5
    p = {
        "wq": normal(gen, lead + (d, cfg.q_dim), s, dt, device),
        "wk": normal(gen, lead + (d, cfg.kv_dim), s, dt, device),
        "wv": normal(gen, lead + (d, cfg.kv_dim), s, dt, device),
        "wo": normal(gen, lead + (cfg.q_dim, d), so, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(lead + (cfg.q_dim,), device)
        p["bk"] = zeros(lead + (cfg.kv_dim,), device)
        p["bv"] = zeros(lead + (cfg.kv_dim,), device)
    if cfg.qk_norm:
        p["q_norm"] = ones(lead + (cfg.head_dim,), device)
        p["k_norm"] = ones(lead + (cfg.head_dim,), device)
    return p


def init_layer(gen, cfg: ModelConfig, kind: str, device, lead=()):
    if kind == "mlstm":
        return {"kind_mlstm": ssm_lib.init_mlstm(gen, cfg, cfg.d_model,
                                                 device, lead)}
    if kind == "slstm":
        return {"kind_slstm": ssm_lib.init_slstm(gen, cfg, cfg.d_model,
                                                 device, lead)}
    p = {"ln2": init_norm(cfg, cfg.d_model, device, lead)}
    if kind == "attn":
        p["ln1"] = init_norm(cfg, cfg.d_model, device, lead)
        p["attn"] = init_attn_weights(gen, cfg, cfg.d_model, device, lead)
    elif kind == "rglru":
        p["rec"] = rglru_lib.init_rglru(gen, cfg, cfg.d_model, device,
                                        lead)  # owns its norm
    else:
        raise ValueError(kind)
    if cfg.d_ff:
        if cfg.moe and kind == "attn":
            p["moe"] = moe_lib.init_moe(gen, cfg, cfg.d_model, device, lead)
        else:
            p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device,
                                lead)
    return p


def init_params(gen, cfg: ModelConfig, device):
    """The JAX tree: embed/table, final_norm, head, and layers_stacked (a
    leading L axis on every leaf) or a list of layers."""
    params = {"embed": init_embedding(gen, cfg, device),
              "final_norm": init_norm(cfg, cfg.d_model, device),
              "head": init_lm_head(gen, cfg, device)}
    if stacked(cfg):
        params["layers_stacked"] = init_layer(gen, cfg, "attn", device,
                                              (cfg.num_layers,))
    else:
        params["layers"] = [init_layer(gen, cfg, kind, device)
                            for kind in cfg.pattern()]
    return params


def layer_params(params, i: int):
    """Layer i's params: a view into the stacked tree, or the list entry."""
    if "layers_stacked" in params:
        return _index(params["layers_stacked"], i)
    return params["layers"][i]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return shd.sub_spec(tree, tree[i])


def unstack(tree, n: int) -> list:
    """The stacked tree as ``n`` per-layer trees, each leaf split once with
    ``torch.unbind`` (views; one backward node a leaf; a rank's block keeps
    its spec)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return [shd.sub_spec(tree, x) for x in torch.unbind(tree, 0)]


def num_layers(params) -> int:
    if "layers_stacked" in params:
        return params["layers_stacked"]["ln2"]["scale"].shape[0]
    return len(params["layers"])


# ================================================================ blocks
def heads_split(p, cfg: ModelConfig, mesh) -> bool:
    """Whether the attention runs column-parallel on this mesh: ``wq``
    holds its ``model`` block of the heads, the heads split evenly, and
    each rank's query heads use whole KV heads of their own (KV heads
    split too) or one KV head shared with their neighbours."""
    m = model_size(mesh)
    if not tensor_parallel(mesh) or not shd.model_split(p["wq"], -1) or \
            cfg.num_heads % m:
        return False
    hq, g = cfg.num_heads // m, cfg.num_heads // cfg.num_kv_heads
    return hq % g == 0 or g % hq == 0


def _kv_heads(cfg: ModelConfig, mesh):
    """(first KV head, KV head count) of this rank's query heads."""
    m = model_size(mesh)
    hq, g = cfg.num_heads // m, cfg.num_heads // cfg.num_kv_heads
    return mesh.axis_index("model") * hq // g, max(hq // g, 1)


def attn_weights(p, cfg: ModelConfig, mesh):
    """The attention weights this rank computes with: its heads' columns of
    wq / wk / wv (and biases) and rows of wo when ``heads_split``, else
    each whole. Returns (weights, query heads, KV heads, split)."""
    if mesh is None:
        return p, cfg.num_heads, cfg.num_kv_heads, False
    if not heads_split(p, cfg, mesh):
        return shd.gathered(p, mesh), cfg.num_heads, cfg.num_kv_heads, False
    m, hd = model_size(mesh), cfg.head_dim
    col, row = shd.P(None, "model"), shd.P("model", None)
    out = {"wq": shd.as_spec(p["wq"], mesh, col),
           "wo": shd.as_spec(p["wo"], mesh, row)}
    kv_split = cfg.num_kv_heads % m == 0
    lo, n = _kv_heads(cfg, mesh)
    for w, b in (("wk", "bk"), ("wv", "bv")):
        if kv_split:
            out[w] = shd.as_spec(p[w], mesh, col)
        else:
            out[w] = shd.whole(p[w], mesh).narrow(1, lo * hd, n * hd)
        if b in p:
            out[b] = shd.as_spec(p[b], mesh, shd.P("model")) if kv_split \
                else shd.whole(p[b], mesh).narrow(0, lo * hd, n * hd)
    if "bq" in p:
        out["bq"] = shd.as_spec(p["bq"], mesh, shd.P("model"))
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = shd.whole(p[k], mesh)
    return out, cfg.num_heads // m, n, True


def _project_qkv(p, cfg: ModelConfig, x, positions, mesh=None):
    """x: (B,S,d) -> q (B,Hq,S,hd), k, v (B,Hkv,S,hd) with rope + qk_norm;
    under a mesh the rank's heads (``attn_weights``)."""
    b, s, _ = x.shape
    p, nq, nkv, _ = attn_weights(p, cfg, mesh)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = (q.to(F32) + p["bq"]).to(x.dtype)
        k = (k.to(F32) + p["bk"]).to(x.dtype)
        v = (v.to(F32) + p["bv"]).to(x.dtype)
    q = q.reshape(b, s, nq, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, nkv, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, nkv, cfg.head_dim).transpose(1, 2)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps)
    if cfg.rotary_pct > 0:
        q = apply_rope(q, positions[None, None, :], cfg)
        k = apply_rope(k, positions[None, None, :], cfg)
    return q, k, v


def _rms_head(x, scale, eps):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def attn_out(p, cfg: ModelConfig, o, mesh=None):
    """o (..., H'*hd) @ wo: under a mesh with ``heads_split`` this rank's
    rows of wo and a ``psum`` over ``model``."""
    if mesh is None:
        return o @ p["wo"]
    if heads_split(p, cfg, mesh):
        return mesh.psum(o @ shd.as_spec(p["wo"], mesh, shd.P("model", None)),
                         "model")
    return o @ shd.whole(p["wo"], mesh)


def attn_full(p, cfg: ModelConfig, x, positions, mesh=None):
    """The attention block over a whole sequence at positions ``arange``:
    (x + attention, k, v), k and v this rank's heads under a mesh. K9
    takes the top-left positions that the prefill and the forward pass, so
    the attention gets ``None`` for them."""
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(p["attn"], cfg, h, positions, mesh)
    o = attn_lib.chunked_attention(
        q, k, v, causal=True, window=cfg.attn_window,
        softcap=cfg.attn_logit_softcap, impl=cfg.attention_impl)
    b, hq, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return x + attn_out(p["attn"], cfg, o, mesh), k, v


def attn_block_full(p, cfg: ModelConfig, x, positions, mesh=None):
    return attn_full(p, cfg, x, positions, mesh)[0]


def ffn_block(p, cfg: ModelConfig, x, mesh=None):
    """x + the layer's MLP or MoE of its norm; (x, aux)."""
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        y, aux = moe_lib.apply_moe(p["moe"], cfg, h, mesh=mesh)
        return x + y, aux
    return x + apply_mlp(p["mlp"], cfg, h, mesh), torch.zeros(
        (), dtype=F32, device=x.device)


def apply_layer_full(p, cfg: ModelConfig, kind: str, x, positions,
                     mesh=None):
    """One layer, full-sequence. Returns (x, aux)."""
    if kind in ("mlstm", "slstm"):
        scan = ssm_lib.mlstm_scan if kind == "mlstm" else ssm_lib.slstm_scan
        return scan(shd.gathered(p["kind_" + kind], mesh), cfg, x), \
            torch.zeros((), dtype=F32, device=x.device)
    if kind == "attn":
        x = attn_block_full(p, cfg, x, positions, mesh)
    elif kind == "rglru":
        # the block owns its norm
        x = rglru_lib.rglru_forward(shd.gathered(p["rec"], mesh), cfg, x)
    else:
        raise ValueError(kind)
    if cfg.d_ff:
        return ffn_block(p, cfg, x, mesh)
    return x, torch.zeros((), dtype=F32, device=x.device)


# ================================================================ forward
# the matrix products whose outputs ``dots_saveable`` keeps (JAX's
# checkpoint_policies.dots_saveable saves every dot_general's output)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig, mesh=None):
    """``fn`` under the config's rematerialisation: 'none' keeps every
    activation; 'full' keeps the layer's inputs and recomputes the rest in
    the backward; 'dots_saveable' keeps the matrix products' outputs too;
    any other mode raises. Non-reentrant ``torch.utils.checkpoint``, as
    JAX's ``jax.checkpoint``; under a mesh its transport's
    (``MeshComm.checkpoint``: a ``LocalMesh`` recomputes every rank's layer
    together behind the baton)."""
    mode = cfg.parallel.remat
    if mode == "none":
        return fn
    if mode not in ("full", "dots_saveable"):
        raise ValueError(f"remat={mode!r}: 'none', 'full' or "
                         f"'dots_saveable'")
    context_fn = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                   _save_dots) \
        if mode == "dots_saveable" else None
    if mesh is None:
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn or
                                 ckpt.noop_context_fn)
    return functools.partial(mesh.checkpoint, fn, context_fn=context_fn)


def embed_inputs(params, cfg: ModelConfig, tokens, extra_embeds=None,
                 mesh=None):
    """Token embeddings with the vlm's patch embeddings prepended (and
    sinusoidal positions where the config has no rotary dims); under a mesh
    this rank's rows of the batch (``constrain``)."""
    if mesh is not None:
        tokens = shd.constrain(tokens, ("batch", None), mesh)
        if extra_embeds is not None:
            extra_embeds = shd.constrain(extra_embeds, ("batch", None, None),
                                         mesh)
    x = embed_tokens(params["embed"], tokens, mesh)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, d = x.shape
    if cfg.rotary_pct == 0:
        x = (x.to(F32) + sinusoidal_positions(s, d, x.device)).to(x.dtype)
    return x


def forward(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            mesh=None, return_hidden=False):
    """tokens: (B, S_text) integer; extra_embeds: (B, P, d) prepended (vlm
    stub). Returns (logits (B,S,V) in the weights' dtype, aux_loss 0-d);
    with return_hidden=True the first element is the final normed hidden
    state (B,S,d) instead. Under a mesh: this rank's rows."""
    x = embed_inputs(params, cfg, tokens, extra_embeds, mesh)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    pattern = cfg.pattern()
    layers = params["layers"] if "layers" in params else \
        unstack(params["layers_stacked"], num_layers(params))
    grad = torch.is_grad_enabled() and x.requires_grad
    for i, layer_p in enumerate(layers):
        fn = functools.partial(apply_layer_full, layer_p, cfg, pattern[i],
                               mesh=mesh)
        if grad:
            fn = _remat(fn, cfg, mesh)
        x, a = fn(x, positions)
        aux_total = aux_total + a
    x = apply_norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    return lm_logits(params["head"], params["embed"], cfg, x, mesh), \
        aux_total


# ================================================================ loss
def cross_entropy(logits, labels, mask=None):
    """Dense CE in f32. logits (B,S,V), labels (B,S)."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - tgt
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def vocab_parallel_cross_entropy(x, embed_p, head_p, cfg: ModelConfig, labels,
                                 mesh, mask=None):
    """Move-compute CE: per-shard partial max / logsumexp / target-dot over
    the vocab shard; only (B, S) statistics cross the ``model`` axis (the
    9-byte-response analogue) instead of gathering (B,S,V) logits. ``x``
    and ``labels`` are this rank's rows; the mean over the batch axes is
    the same on every rank. The max is a constant of the gradient (it
    cancels in the loss), so it is taken without one."""
    del mask                            # unused, as in the JAX module
    w = head_weight(head_p, embed_p, cfg, mesh, vocab_split=True)
    baxes = shd.batch_axes(mesh)
    v_loc = w.shape[1]
    idx = mesh.axis_index("model")
    logits = (x @ w).to(F32)                              # (B,S,Vloc)
    m = mesh.pmax(torch.amax(logits.detach(), -1), "model")
    lse_loc = torch.sum(torch.exp(logits - m[..., None]), -1)
    lse = torch.log(mesh.psum(lse_loc, "model")) + m
    lo = idx * v_loc
    labels = labels.long()
    inshard = (labels >= lo) & (labels < lo + v_loc)
    tgt_loc = torch.where(
        inshard,
        torch.take_along_dim(
            logits, torch.clamp(labels - lo, 0, v_loc - 1)[..., None],
            dim=-1)[..., 0],
        0.0)
    tgt = mesh.psum(tgt_loc, "model")
    nll = lse - tgt
    nll = mesh.pmean(nll, baxes)
    return torch.mean(nll)
