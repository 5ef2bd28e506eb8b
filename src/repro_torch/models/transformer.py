"""Decoder-only LM assembled from blocks (attn / rglru), full-sequence form.

The port of the JAX package's ``repro/models/transformer.py`` for the dense,
vlm and hybrid families. Uniform attention configs keep JAX's stacked layout
(``layers_stacked``: every leaf with a leading L axis) and loop over it in
Python; heterogeneous patterns keep a list (``layers``). One device and no
mesh: the sharding constraints of the JAX module drop out, and a ``mesh``
raises (the sharded paths are ROADMAP Queue 1 item 14f). Not here yet:
``_remat`` and training (item 14e), ``vocab_parallel_cross_entropy``
(14f), the moe block (14b), the xLSTM blocks (14c).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope,
                                       dtype_of, embed_tokens,
                                       init_embedding, init_lm_head,
                                       init_mlp, init_norm, lm_logits, normal,
                                       ones, sinusoidal_positions, zeros)

F32 = torch.float32

# the JAX package's families and blocks that later slices port
LATER = {"moe": "ROADMAP Queue 1 item 14b (moe.py)",
         "ssm": "ROADMAP Queue 1 item 14c (ssm.py / xlstm)",
         "mlstm": "ROADMAP Queue 1 item 14c (ssm.py / xlstm)",
         "slstm": "ROADMAP Queue 1 item 14c (ssm.py / xlstm)",
         "audio": "ROADMAP Queue 1 item 14d (encdec.py / whisper)",
         "mesh": "ROADMAP Queue 1 item 14f (the sharded paths)"}


def no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            f"the port runs the LM on one device without a mesh; sharded "
            f"layouts are {LATER['mesh']}")


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
    if kind in ("mlstm", "slstm"):
        raise NotImplementedError(f"{kind} blocks are {LATER[kind]}")
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
            raise NotImplementedError(f"MoE layers are {LATER['moe']}")
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device, lead)
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
    return tree[i]


def num_layers(params) -> int:
    if "layers_stacked" in params:
        return params["layers_stacked"]["ln2"]["scale"].shape[0]
    return len(params["layers"])


# ================================================================ blocks
def _project_qkv(p, cfg: ModelConfig, x, positions):
    """x: (B,S,d) -> q (B,Hq,S,hd), k, v (B,Hkv,S,hd) with rope + qk_norm."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = (q.to(F32) + p["bq"]).to(x.dtype)
        k = (k.to(F32) + p["bk"]).to(x.dtype)
        v = (v.to(F32) + p["bv"]).to(x.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
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


def attn_full(p, cfg: ModelConfig, x, positions):
    """The attention block over a whole sequence at positions ``arange``:
    (x + attention, k, v). K9 takes the top-left positions that the prefill
    and the forward pass, so the attention gets ``None`` for them."""
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(p["attn"], cfg, h, positions)
    o = attn_lib.chunked_attention(
        q, k, v, causal=True, window=cfg.attn_window,
        softcap=cfg.attn_logit_softcap, impl=cfg.attention_impl)
    b, hq, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return x + o @ p["attn"]["wo"], k, v


def attn_block_full(p, cfg: ModelConfig, x, positions):
    return attn_full(p, cfg, x, positions)[0]


def ffn_block(p, cfg: ModelConfig, x, mesh=None):
    no_mesh(mesh)
    h = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(p["mlp"], cfg, h), torch.zeros((), dtype=F32,
                                                        device=x.device)


def apply_layer_full(p, cfg: ModelConfig, kind: str, x, positions,
                     mesh=None):
    """One layer, full-sequence. Returns (x, aux)."""
    if kind == "attn":
        x = attn_block_full(p, cfg, x, positions)
    elif kind == "rglru":
        x = rglru_lib.rglru_forward(p["rec"], cfg, x)  # block owns its norm
    else:
        raise NotImplementedError(f"{kind} blocks are {LATER.get(kind)}")
    if cfg.d_ff:
        return ffn_block(p, cfg, x, mesh)
    return x, torch.zeros((), dtype=F32, device=x.device)


# ================================================================ forward
def embed_inputs(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """Token embeddings with the vlm's patch embeddings prepended (and
    sinusoidal positions where the config has no rotary dims)."""
    x = embed_tokens(params["embed"], tokens)
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
    state (B,S,d) instead."""
    no_mesh(mesh)
    x = embed_inputs(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    pattern = cfg.pattern()
    for i in range(num_layers(params)):
        x, a = apply_layer_full(layer_params(params, i), cfg, pattern[i], x,
                                positions)
        aux_total = aux_total + a
    x = apply_norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    return lm_logits(params["head"], params["embed"], cfg, x), aux_total


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
