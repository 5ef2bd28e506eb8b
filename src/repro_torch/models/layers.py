"""Shared building blocks: norms, RoPE, MLPs, embeddings.

The port of the JAX package's ``repro/models/layers.py``. Params are plain
dicts of tensors; every init_* has a matching apply_*. Weights are stored in
cfg.dtype (bf16 by default); norms accumulate in float32 and cast back.

Initialisation draws from ``gen``, a ``torch.Generator`` on the target
device (``None`` on the ``meta`` device, which allocates nothing): the same
tree keys, shapes, dtypes and scales as the JAX init, but not its numbers
(``jax.random`` is another generator). ``lead`` prepends axes to every leaf,
as the JAX package's ``vmap`` over stacked layers does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

F32 = torch.float32


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen, shape, scale, dtype, device):
    """N(0, 1) * scale drawn in float32, then cast (as the JAX init)."""
    x = torch.randn(tuple(shape), generator=gen, dtype=F32, device=device)
    return x.mul_(scale).to(dtype)


def ones(shape, device):
    return torch.ones(tuple(shape), dtype=F32, device=device)


def zeros(shape, device):
    return torch.zeros(tuple(shape), dtype=F32, device=device)


# ---------------------------------------------------------------- norms
def init_rmsnorm(d: int, device, lead=()):
    return {"scale": ones(lead + (d,), device)}


def apply_rmsnorm(p, x, eps: float):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def init_layernorm(d: int, device, lead=()):
    return {"scale": ones(lead + (d,), device),
            "bias": zeros(lead + (d,), device)}


def apply_layernorm(p, x, eps: float):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def init_norm(cfg: ModelConfig, d: int, device, lead=()):
    # whisper/starcoder2-style models use LayerNorm; the rest RMSNorm
    if cfg.family == "audio" or not cfg.mlp_gated and cfg.family == "dense" \
            and cfg.name.startswith("starcoder2"):
        return init_layernorm(d, device, lead)
    return init_rmsnorm(d, device, lead)


def apply_norm(cfg: ModelConfig, p, x):
    if "bias" in p:
        return apply_layernorm(p, x, cfg.norm_eps)
    return apply_rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, rotary_pct: float, theta: float, device):
    """(rot/2,) float32 inverse frequencies, or None without rotary dims.
    Computed on ``device`` with tensor ops (no copy from the host, so a
    decode step never waits for one)."""
    rot = int(head_dim * rotary_pct) // 2 * 2
    if rot == 0:
        return None
    ex = torch.arange(0, rot, 2, dtype=F32, device=device) / rot
    return 1.0 / torch.pow(float(theta), ex)


def apply_rope(x, positions, cfg: ModelConfig):
    """x: (..., S, head_dim); positions: (..., S) integer. Half-split
    convention (not interleaved), applied to the first rotary_pct of
    head_dim (chatglm3: 0.5)."""
    inv = rope_freqs(x.shape[-1], cfg.rotary_pct, cfg.rope_theta, x.device)
    if inv is None:
        return x
    rot = inv.shape[0] * 2
    ang = positions[..., None].to(F32) * inv  # (..., S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


def sinusoidal_positions(seq: int, d: int, device):
    """Whisper-style fixed sinusoidal embeddings (seq, d) in float32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


# ---------------------------------------------------------------- MLP
def init_mlp(gen, cfg: ModelConfig, d: int, d_ff: int, device, lead=()):
    s_in = d ** -0.5
    s_out = d_ff ** -0.5
    dt = dtype_of(cfg)
    p = {"w_up": normal(gen, lead + (d, d_ff), s_in, dt, device),
         "w_down": normal(gen, lead + (d_ff, d), s_out, dt, device)}
    if cfg.mlp_gated:
        p["w_gate"] = normal(gen, lead + (d, d_ff), s_in, dt, device)
    return p


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, cfg: ModelConfig, x):
    up = x @ p["w_up"]
    if cfg.mlp_gated:
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = gelu(up)
    return h @ p["w_down"]


# ---------------------------------------------------------------- embeddings
def init_embedding(gen, cfg: ModelConfig, device):
    emb = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype_of(cfg),
                 device)
    return {"table": emb}


def embed_tokens(p, tokens):
    return F.embedding(tokens, p["table"])


def init_lm_head(gen, cfg: ModelConfig, device):
    if cfg.tie_embeddings:
        return {}
    w = normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
               dtype_of(cfg), device)
    return {"w": w}


def lm_logits(head_p, embed_p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ embed_p["table"].T
    return x @ head_p["w"]
