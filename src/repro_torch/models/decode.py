"""Serving: prefill (full-sequence forward producing the decode state) and
single-token decode steps for the attn and rglru blocks.

The port of the JAX package's ``repro/models/decode.py``. State layouts:
  attn (full)    : k, v (B, Hkv, S_max, hd)          slot = position
  attn (window)  : k, v (B, Hkv, W, hd)  ring buffer  slot = position % W
  rglru          : h (B, W), conv_tail (B, K-1, W)
Stacked configs keep one (L, ...) tensor a leaf, as JAX's scan does.
``pos`` is a 0-d int32 tensor on the device: the cache write and the masks
read it there, so a decode step never waits for the host.

Unlike JAX's functional update, ``decode_step`` writes the new position's k
and v into the caches in place (the state it returns holds the same cache
tensors): that saves a copy of every cache a step. Clone a state to decode
from it twice. Not here yet: the split-KV decode and ``state_shardings``
(ROADMAP Queue 1 item 14f), the xLSTM states (14c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.layers import (apply_norm, dtype_of, embed_tokens,
                                       lm_logits, sinusoidal_positions)
from repro_torch.models.transformer import (LATER, _project_qkv, attn_full,
                                            embed_inputs, ffn_block,
                                            layer_params, no_mesh,
                                            num_layers, stacked)


# ================================================================ state init
def _attn_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                lead=()):
    s = cfg.attn_window if cfg.attn_window else max_seq
    shape = lead + (batch, cfg.num_kv_heads, s, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_layer_state(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device):
    if kind == "attn":
        return _attn_cache(cfg, batch, max_seq, device)
    if kind == "rglru":
        return rglru_lib.rglru_init_state(cfg, batch, cfg.d_model, device)
    if kind in ("mlstm", "slstm"):
        raise NotImplementedError(f"{kind} states are {LATER[kind]}")
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    if stacked(cfg):
        layers = _attn_cache(cfg, batch, max_seq, device, (cfg.num_layers,))
    else:
        layers = [init_layer_state(cfg, k, batch, max_seq, device)
                  for k in cfg.pattern()]
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": layers}


def layer_state(state_layers, i: int):
    if isinstance(state_layers, dict):      # stacked: views of slice i
        return {k: v[i] for k, v in state_layers.items()}
    return state_layers[i]


# ================================================================ attn decode
def _ring_positions(cfg: ModelConfig, pos, cache_slots: int):
    """Global position held by each cache slot after writing position
    ``pos``."""
    slots = torch.arange(cache_slots, device=pos.device)
    if cfg.attn_window:
        return pos - ((pos - slots) % cache_slots)
    return slots


def attn_block_decode(p, cfg: ModelConfig, x_t, cache, pos, mesh=None):
    """x_t: (B, d); cache k/v (B,Hkv,S,hd); pos 0-d tensor -> (y, cache),
    the cache written in place."""
    no_mesh(mesh)
    b, d = x_t.shape
    h = apply_norm(cfg, p["ln1"], x_t[:, None, :])
    q, k, v = _project_qkv(p["attn"], cfg, h, pos[None])
    q = q[:, :, 0, :]                                    # (B,Hq,hd)
    s_cache = cache["k"].shape[2]
    slot = pos % s_cache if cfg.attn_window else pos
    # dynamic_update_slice clamps its start into the cache
    slot = torch.clamp(slot, 0, s_cache - 1).to(torch.long).reshape(1)
    cache["k"].index_copy_(2, slot, k)
    cache["v"].index_copy_(2, slot, v)
    kv_pos = _ring_positions(cfg, pos, s_cache)
    o, m, l = attn_lib.decode_attention(
        q, cache["k"], cache["v"], kv_pos, pos + 1, window=cfg.attn_window,
        softcap=cfg.attn_logit_softcap)
    o = attn_lib.finalize_partial(o, m, l)
    y = o.reshape(b, cfg.q_dim).to(x_t.dtype) @ p["attn"]["wo"]
    return x_t + y, cache


def apply_layer_decode(p, cfg: ModelConfig, kind, x_t, lstate, pos,
                       mesh=None):
    if kind == "attn":
        x_t, lstate = attn_block_decode(p, cfg, x_t, lstate, pos, mesh)
    elif kind == "rglru":
        x_t, lstate = rglru_lib.rglru_step(p["rec"], cfg, x_t, lstate)
    else:
        raise NotImplementedError(f"{kind} blocks are {LATER.get(kind)}")
    if cfg.d_ff:
        x3, _ = ffn_block(p, cfg, x_t[:, None, :], mesh)
        x_t = x3[:, 0, :]
    return x_t, lstate


def decode_step(params, cfg: ModelConfig, state, tokens, *, mesh=None):
    """One token for every sequence. tokens: (B,) integer -> (logits (B,V),
    state)."""
    no_mesh(mesh)
    pos = state["pos"]
    x = embed_tokens(params["embed"], tokens)            # (B, d)
    if cfg.rotary_pct == 0:
        pe = sinusoidal_positions(1, x.shape[-1], x.device)[0]  # stub table
        x = (x.to(torch.float32) + pe).to(x.dtype)
    pattern = cfg.pattern()
    layers = state["layers"]
    new_layers = []
    for i in range(num_layers(params)):
        x, s_n = apply_layer_decode(layer_params(params, i), cfg, pattern[i],
                                    x, layer_state(layers, i), pos, mesh)
        new_layers.append(s_n)
    if isinstance(layers, dict):
        new_layers = layers                  # written in place
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_logits(params["head"], params["embed"], cfg, x)
    return logits, {"pos": pos + 1, "layers": new_layers}


# ================================================================ prefill
def _attn_prefill(p, cfg: ModelConfig, x, positions):
    x, k, v = attn_full(p, cfg, x, positions)
    if cfg.attn_window:
        w = cfg.attn_window
        s_len = positions.shape[0]
        if s_len >= w:
            # last w positions; position p = s-w+i sits at slot p % w
            roll = s_len % w
            k = torch.roll(k[:, :, -w:, :], roll, dims=2)
            v = torch.roll(v[:, :, -w:, :], roll, dims=2)
        else:
            # prompt shorter than the window: slots == positions, pad
            k = F.pad(k, (0, 0, 0, w - s_len))
            v = F.pad(v, (0, 0, 0, w - s_len))
    return x, {"k": k, "v": v}


def _pad_full(t, pad_cache_to: int):
    """Grow a full (non-ring) cache (B, Hkv, S, hd) to pad_cache_to slots."""
    if pad_cache_to and t.shape[2] < pad_cache_to:
        return F.pad(t, (0, 0, 0, pad_cache_to - t.shape[2]))
    return t.contiguous()


def prefill(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            mesh=None, pad_cache_to=0):
    """Full-sequence forward that also returns the decode state.
    Returns (last-position logits (B,V), state)."""
    no_mesh(mesh)
    x = embed_inputs(params, cfg, tokens, extra_embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    pattern = cfg.pattern()
    layers = []
    for i in range(num_layers(params)):
        layer_p, kind = layer_params(params, i), pattern[i]
        if kind == "attn":
            x, st = _attn_prefill(layer_p, cfg, x, positions)
            if not cfg.attn_window:
                st = {k: _pad_full(t, pad_cache_to) for k, t in st.items()}
        elif kind == "rglru":
            x, st = rglru_lib.rglru_forward(layer_p["rec"], cfg, x,
                                            return_state=True)
        else:
            raise NotImplementedError(f"{kind} blocks are {LATER.get(kind)}")
        if cfg.d_ff:
            x, _ = ffn_block(layer_p, cfg, x)
        layers.append(st)
    if "layers_stacked" in params:
        layers = {k: torch.stack([st[k] for st in layers]) for k in ("k", "v")}
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    logits = lm_logits(params["head"], params["embed"], cfg, x)[:, 0, :]
    return logits, {"pos": torch.full((), s, dtype=torch.int32,
                                      device=x.device),
                    "layers": layers}
