"""Whisper-style encoder-decoder backbone.

The port of the JAX package's ``repro/models/encdec.py``. The conv audio
frontend is a STUB in both packages: the batch carries precomputed frame
embeddings (B, S_enc, d_model). Positions are sinusoidal.

Every attention of the encoder and of the decoder's prefill (the
encoder's non-causal self-attention, the decoder's causal self-attention,
the cross-attention onto the encoder's memory) runs through
``attention.chunked_attention``, so K9 under the ``fused`` lowering on the
card. The JAX ``_mha`` passes explicit ``arange`` positions; without a
window they are the top-left positions that ``None`` stands for, so the
port passes ``None`` (K9 takes no explicit positions). A decode step's
self- and cross-attention are the plain ``decode_attention``, as in JAX;
its position embedding is computed on the device at the clamped ``pos``
(JAX's ``dynamic_slice`` of the table), and its k and v are written into
the caches in place, as ``decode.attn_block_decode`` writes them.

A ``mesh`` is taken and otherwise ignored, as JAX's ``encdec`` ignores it:
the params of a rank (its blocks, ``parallel/sharding.py``) are gathered
whole and every rank computes the whole batch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.decode import _pad_full
from repro_torch.models.layers import (apply_mlp, apply_norm, dtype_of,
                                       embed_tokens, init_embedding,
                                       init_lm_head, init_mlp, init_norm,
                                       lm_logits, sinusoidal_at,
                                       sinusoidal_positions)
from repro_torch.models.transformer import _project_qkv, init_attn_weights
from repro_torch.parallel import sharding as shd

F32 = torch.float32


def _heads(t, b, s, h, hd):
    """(B, S, h*hd) -> (B, h, S, hd)."""
    return t.reshape(b, s, h, hd).transpose(1, 2)


def _kv(p, cfg: ModelConfig, xkv):
    b, skv, _ = xkv.shape
    return (_heads(xkv @ p["wk"], b, skv, cfg.num_kv_heads, cfg.head_dim),
            _heads(xkv @ p["wv"], b, skv, cfg.num_kv_heads, cfg.head_dim))


def _attend(p, cfg: ModelConfig, q, k, v, causal):
    b, _, sq, _ = q.shape
    o = attn_lib.chunked_attention(q, k, v, causal=causal,
                                   impl=cfg.attention_impl)
    return o.transpose(1, 2).reshape(b, sq, cfg.q_dim) @ p["wo"]


def _mha(p, cfg: ModelConfig, xq, xkv, causal, kv=None):
    """Full attention between xq (B,Sq,d) and xkv (B,Skv,d); ``kv`` the
    (k, v) of xkv when the caller has them."""
    b, sq, _ = xq.shape
    q = _heads(xq @ p["wq"], b, sq, cfg.num_heads, cfg.head_dim)
    k, v = kv if kv is not None else _kv(p, cfg, xkv)
    return _attend(p, cfg, q, k, v, causal)


def init_enc_layer(gen, cfg: ModelConfig, device):
    return {"ln1": init_norm(cfg, cfg.d_model, device),
            "attn": init_attn_weights(gen, cfg, cfg.d_model, device),
            "ln2": init_norm(cfg, cfg.d_model, device),
            "mlp": init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)}


def init_dec_layer(gen, cfg: ModelConfig, device):
    return {"ln1": init_norm(cfg, cfg.d_model, device),
            "attn": init_attn_weights(gen, cfg, cfg.d_model, device),
            "ln_x": init_norm(cfg, cfg.d_model, device),
            "xattn": init_attn_weights(gen, cfg, cfg.d_model, device),
            "ln2": init_norm(cfg, cfg.d_model, device),
            "mlp": init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)}


def init_params(gen, cfg: ModelConfig, device):
    return {
        "embed": init_embedding(gen, cfg, device),
        "head": init_lm_head(gen, cfg, device),
        "enc_layers": [init_enc_layer(gen, cfg, device)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [init_dec_layer(gen, cfg, device)
                       for _ in range(cfg.num_layers)],
        "enc_norm": init_norm(cfg, cfg.d_model, device),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }


def _with_positions(x):
    return (x.to(F32) + sinusoidal_positions(x.shape[1], x.shape[2],
                                             x.device)).to(x.dtype)


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, S_enc, d) precomputed embeddings -> memory (B, S_enc,
    d)."""
    x = _with_positions(frames.to(dtype_of(cfg)))
    for p in params["enc_layers"]:
        h = apply_norm(cfg, p["ln1"], x)
        x = x + _mha(p["attn"], cfg, h, h, causal=False)
        h = apply_norm(cfg, p["ln2"], x)
        x = x + apply_mlp(p["mlp"], cfg, h)
    return apply_norm(cfg, params["enc_norm"], x)


def _decoder(params, cfg: ModelConfig, mem, tokens, keep_kv=False):
    """The decoder over the whole token sequence: the final hidden state
    (B,S,d) and, with ``keep_kv``, each layer's self k / v and cross k / v
    (B, Hkv, S or S_enc, hd)."""
    x = _with_positions(embed_tokens(params["embed"], tokens))
    kvs = []
    for p in params["dec_layers"]:
        h = apply_norm(cfg, p["ln1"], x)
        k, v = _kv(p["attn"], cfg, h)
        x = x + _mha(p["attn"], cfg, h, h, causal=True, kv=(k, v))
        h = apply_norm(cfg, p["ln_x"], x)
        xk, xv = _kv(p["xattn"], cfg, mem)
        x = x + _mha(p["xattn"], cfg, h, mem, causal=False, kv=(xk, xv))
        h = apply_norm(cfg, p["ln2"], x)
        x = x + apply_mlp(p["mlp"], cfg, h)
        if keep_kv:
            kvs.append((k, v, xk, xv))
    return x, kvs


def forward(params, cfg: ModelConfig, frames, tokens, *, mesh=None,
            return_hidden=False):
    """Teacher-forced decoder over the full token sequence. -> (logits,
    aux = 0); with ``return_hidden`` the final normed hidden state
    (B,S,d) in place of the logits."""
    params = shd.gathered(params, mesh)
    mem = encode(params, cfg, frames)
    x, _ = _decoder(params, cfg, mem, tokens)
    x = apply_norm(cfg, params["final_norm"], x)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if return_hidden:
        return x, aux
    return lm_logits(params["head"], params["embed"], cfg, x), aux


# ---------------------------------------------------------------- serving
def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    dt = dtype_of(cfg)
    kv = (batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    xkv = (batch, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)
    layers = [{"k": torch.zeros(kv, dtype=dt, device=device),
               "v": torch.zeros(kv, dtype=dt, device=device),
               "xk": torch.zeros(xkv, dtype=dt, device=device),
               "xv": torch.zeros(xkv, dtype=dt, device=device)}
              for _ in range(cfg.num_layers)]
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": layers}


def prefill(params, cfg: ModelConfig, frames, tokens, *, mesh=None,
            pad_cache_to=0):
    """Encode the audio and run the decoder over the prompt, building all
    caches. Returns (last-position logits (B,V), state)."""
    params = shd.gathered(params, mesh)
    mem = encode(params, cfg, frames)
    s = tokens.shape[1]
    x, kvs = _decoder(params, cfg, mem, tokens, keep_kv=True)
    layers = [{"k": _pad_full(k, pad_cache_to), "v": _pad_full(v, pad_cache_to),
               "xk": xk.contiguous(), "xv": xv.contiguous()}
              for k, v, xk, xv in kvs]
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    logits = lm_logits(params["head"], params["embed"], cfg, x)[:, 0, :]
    return logits, {"pos": torch.full((), s, dtype=torch.int32,
                                      device=x.device),
                    "layers": layers}


def _decode_attend(p, cfg: ModelConfig, x, q, k, v, kv_pos, cache_len):
    o, m, l = attn_lib.decode_attention(q, k, v, kv_pos, cache_len)
    o = attn_lib.finalize_partial(o, m, l)
    return x + o.reshape(x.shape[0], cfg.q_dim).to(x.dtype) @ p["wo"]


def decode_step(params, cfg: ModelConfig, state, tokens, *, mesh=None):
    """One token for every sequence. tokens: (B,) integer -> (logits (B,V),
    state), the self-attention caches written in place."""
    params = shd.gathered(params, mesh)
    pos = state["pos"]
    b = tokens.shape[0]
    x = embed_tokens(params["embed"], tokens)
    s_cache = state["layers"][0]["k"].shape[2]
    # the table's row at pos (dynamic_slice clamps its start into it)
    row = torch.clamp(pos, 0, s_cache - 1)
    x = (x.to(F32) + sinusoidal_at(row, x.shape[-1])).to(x.dtype)
    slot = row.to(torch.long).reshape(1)
    kv_pos = torch.arange(s_cache, device=x.device)
    s_enc = state["layers"][0]["xk"].shape[2]
    x_pos = torch.arange(s_enc, device=x.device)
    for p, lstate in zip(params["dec_layers"], state["layers"]):
        h = apply_norm(cfg, p["ln1"], x[:, None, :])
        q, k, v = _project_qkv(p["attn"], cfg, h, pos[None])
        lstate["k"].index_copy_(2, slot, k)
        lstate["v"].index_copy_(2, slot, v)
        x = _decode_attend(p["attn"], cfg, x, q[:, :, 0, :], lstate["k"],
                           lstate["v"], kv_pos, pos + 1)
        # cross attention against the fixed encoder K/V
        h = apply_norm(cfg, p["ln_x"], x[:, None, :])
        qx = (h @ p["xattn"]["wq"]).reshape(b, cfg.num_heads, cfg.head_dim)
        x = _decode_attend(p["xattn"], cfg, x, qx, lstate["xk"],
                           lstate["xv"], x_pos, s_enc)
        h = apply_norm(cfg, p["ln2"], x)
        x = x + apply_mlp(p["mlp"], cfg, h)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_logits(params["head"], params["embed"], cfg, x)
    return logits, {"pos": pos + 1, "layers": state["layers"]}
