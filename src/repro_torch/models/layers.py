"""Shared building blocks: norms, RoPE, MLPs, embeddings.

The port of the JAX package's ``repro/models/layers.py``. Params are plain
dicts of tensors; every init_* has a matching apply_*. Weights are stored in
cfg.dtype (bf16 by default); norms accumulate in float32 and cast back.

Initialisation draws from ``gen``, a ``torch.Generator`` on the target
device (``None`` on the ``meta`` device, which allocates nothing): the same
tree keys, shapes, dtypes and scales as the JAX init, but not its numbers
(``jax.random`` is another generator). ``lead`` prepends axes to every leaf,
as the JAX package's ``vmap`` over stacked layers does.

Under a mesh (``mesh``: a rank's ``dist.MeshComm``) the weights are the
rank's blocks (``parallel/sharding.py``): ``apply_mlp`` runs column-parallel
(``model`` on d_ff) with a ``psum`` over ``model`` after the down
projection, or on the gathered weights; ``embed_tokens`` looks a table with
``model`` on its vocab up vocab-parallel (each rank its rows, a ``psum``);
``lm_logits`` computes this rank's vocab columns and gathers them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import sharding as shd

F32 = torch.float32
# a leaf with more elements than this (a float32 draw above 16 GiB:
# moonshot-v1-16b-a3b's stacked experts, (48, 64, 2048, 1408)) is drawn one
# leading slice at a time into the target dtype; smaller leaves in one draw
SLICE_ELEMENTS = 2 ** 32



def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen, shape, scale, dtype, device):
    """N(0, 1) * scale drawn in float32, then cast (as the JAX init); above
    ``SLICE_ELEMENTS`` a leading slice at a time, so that no float32 copy
    of the whole leaf is held."""
    shape = tuple(shape)
    if gen is None or math.prod(shape) <= SLICE_ELEMENTS:
        x = torch.randn(shape, generator=gen, dtype=F32, device=device)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = normal(gen, shape[1:], scale, dtype, device)
    return out


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


def sinusoidal_at(positions, d: int):
    """Rows ``positions`` (an integer tensor, read on its device) of the
    whisper-style sinusoidal table: (..., d) float32, computed in float64
    as the reference's numpy table is, then rounded (no copy from the
    host, so a decode step never waits for one)."""
    f64 = torch.float64
    i = torch.arange(d // 2, dtype=f64, device=positions.device)
    ang = positions.to(f64)[..., None] / torch.pow(10_000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(F32)


def sinusoidal_positions(seq: int, d: int, device):
    """Whisper-style fixed sinusoidal embeddings (seq, d) in float32."""
    return sinusoidal_at(torch.arange(seq, device=device), d)


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


def _mlp(p, cfg: ModelConfig, x):
    up = x @ p["w_up"]
    if cfg.mlp_gated:
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = gelu(up)
    return h @ p["w_down"]


def model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def tensor_parallel(mesh) -> bool:
    """Whether the ``model`` ranks share their rows and split the weights
    (the ``tp`` layout; under ``fsdp`` ``model`` is a batch axis)."""
    return model_size(mesh) > 1 and "model" not in shd.batch_axes(mesh)


def apply_mlp(p, cfg: ModelConfig, x, mesh=None):
    """The MLP; under a mesh column-parallel where ``w_up`` holds its
    ``model`` block of d_ff (``w_down`` then row-parallel, a ``psum`` over
    ``model``), else on the weights gathered whole."""
    if mesh is None:
        return _mlp(p, cfg, x)
    if tensor_parallel(mesh) and shd.model_split(p["w_up"], -1):
        col, row = shd.P(None, "model"), shd.P("model", None)
        q = {k: shd.as_spec(w, mesh, row if k == "w_down" else col)
             for k, w in p.items()}
        return mesh.psum(_mlp(q, cfg, x), "model")
    return _mlp(shd.gathered(p, mesh), cfg, x)


# ---------------------------------------------------------------- embeddings
def init_embedding(gen, cfg: ModelConfig, device):
    emb = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype_of(cfg),
                 device)
    return {"table": emb}


def embed_tokens(p, tokens, mesh=None):
    table = p["table"]
    if mesh is None:
        return F.embedding(tokens, table)
    if tensor_parallel(mesh) and shd.model_split(table, 0):
        # vocab-parallel: this rank's rows, the others' zero, summed
        t = shd.as_spec(table, mesh, shd.P("model", None))
        v_loc = t.shape[0]
        local = tokens.long() - mesh.axis_index("model") * v_loc
        ok = (local >= 0) & (local < v_loc)
        e = F.embedding(torch.where(ok, local, 0), t) * ok[..., None].to(
            t.dtype)
        return mesh.psum(e, "model")
    return F.embedding(tokens, shd.whole(table, mesh))


def init_lm_head(gen, cfg: ModelConfig, device):
    if cfg.tie_embeddings:
        return {}
    w = normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
               dtype_of(cfg), device)
    return {"w": w}


def head_weight(head_p, embed_p, cfg: ModelConfig, mesh=None,
                vocab_split: bool = False):
    """The (d, V) output projection (the table transposed when tied): under
    a mesh this rank's ``model`` block of V with ``vocab_split``, else
    whole."""
    w = embed_p["table"] if cfg.tie_embeddings else head_p["w"]
    vdim = 0 if cfg.tie_embeddings else 1
    if mesh is not None:
        spec = [None, None]
        spec[vdim] = "model" if vocab_split else None
        w = shd.as_spec(w, mesh, shd.P(*spec))
    return w.T if cfg.tie_embeddings else w


def lm_logits(head_p, embed_p, cfg: ModelConfig, x, mesh=None):
    """Logits over the whole vocab; under a mesh whose head holds its
    ``model`` block of V, this rank's columns computed and gathered."""
    if mesh is None:
        return x @ head_weight(head_p, embed_p, cfg)
    w = embed_p["table"] if cfg.tie_embeddings else head_p["w"]
    split = tensor_parallel(mesh) and shd.model_split(
        w, 0 if cfg.tie_embeddings else 1)
    out = x @ head_weight(head_p, embed_p, cfg, mesh, split)
    return mesh.all_gather(out, "model", -1) if split else out
