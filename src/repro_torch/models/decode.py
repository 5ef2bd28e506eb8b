"""Serving: prefill (full-sequence forward producing the decode state) and
single-token decode steps for every block kind (attn with its MLP or MoE,
rglru, mlstm, slstm).

The port of the JAX package's ``repro/models/decode.py``. State layouts:
  attn (full)    : k, v (B, Hkv, S_max, hd)          slot = position
  attn (window)  : k, v (B, Hkv, W, hd)  ring buffer  slot = position % W
  rglru          : h (B, W), conv_tail (B, K-1, W)
  mlstm / slstm  : recurrent dicts from ``models/ssm.py``
Stacked configs keep one (L, ...) tensor a leaf, as JAX's scan does.
``pos`` is a 0-d int32 tensor on the device: the cache write and the masks
read it there, so a decode step never waits for the host.

Unlike JAX's functional update, ``decode_step`` writes the new position's k
and v into the caches in place (the state it returns holds the same cache
tensors): that saves a copy of every cache a step. Clone a state to decode
from it twice. The xLSTM prefill keeps each scan's own final carry (JAX
replays the step form over the sequence for it).

Under a mesh (``mesh``: a rank's ``dist.MeshComm``) each rank holds its
rows of the batch, and ``decode_attention='split_kv'`` (the default) shards
a full cache's sequence axis over ``model``: each rank keeps every KV head
for its S/model slots, computes the partial softmax of the new position's
query (all heads, gathered) over them, and ``attention.combine_partial``
merges the partials, so only (o, m, l) cross the axis and never the cache
(the paper's move-compute pattern). The prefill hands each rank its slots
with one ``all_to_all`` (heads in, sequence out) and pads the cache to a
multiple of ``model`` slots (the padding is never a valid position, so it
changes no result). A window's ring, or ``decode_attention='local'``,
keeps every KV head on every ``model`` rank, as JAX's
``state_shardings``. The logits returned are the whole batch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_norm, dtype_of, embed_tokens,
                                       lm_logits, model_size,
                                       sinusoidal_positions)
from repro_torch.models.transformer import (_project_qkv, attn_full,
                                            attn_out, embed_inputs,
                                            ffn_block, heads_split,
                                            layer_params, num_layers,
                                            stacked)
from repro_torch.parallel import sharding as shd


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
    if kind == "mlstm":
        return ssm_lib.mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return ssm_lib.slstm_init_state(cfg, batch, cfg.d_model, device)
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    if stacked(cfg):
        layers = _attn_cache(cfg, batch, max_seq, device, (cfg.num_layers,))
    else:
        layers = [init_layer_state(cfg, k, batch, max_seq, device)
                  for k in cfg.pattern()]
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": layers}


def state_shardings(cfg: ModelConfig, state_shapes, mesh, batch: int):
    """The spec of every leaf of a decode state (JAX's rules: the batch
    over the batch axes where they divide it, and a full cache's sequence
    axis over ``model`` under split-KV)."""
    import math as _math
    baxes = shd.batch_axes(mesh)
    bsize = _math.prod(mesh.shape[a] for a in baxes) if baxes else 1
    is_stacked = not isinstance(state_shapes.get("layers"), list)
    split_kv = cfg.parallel.decode_attention == "split_kv" and \
        mesh.shape.get("model", 1) > 1 and not cfg.attn_window

    def one(path, leaf):
        name = shd._path_str(path)
        nd = len(leaf.shape)
        if name.endswith("pos"):
            return shd.P()
        off = 1 if (is_stacked and name.startswith("layers")) else 0
        spec = [None] * nd
        if nd > off and leaf.shape[off] % max(bsize, 1) == 0 and \
                leaf.shape[off] >= bsize:
            spec[off] = baxes
        if split_kv and (name.endswith("/k") or name.endswith("/v")) and \
                nd == off + 4 and \
                leaf.shape[off + 2] % mesh.shape["model"] == 0:
            spec[off + 2] = "model"
        return shd.P(*spec)

    return shd._map_named(one, state_shapes)


def split_kv(cfg: ModelConfig, mesh) -> bool:
    """Whether a full cache's sequence axis is split over ``model``."""
    return cfg.parallel.decode_attention == "split_kv" and \
        model_size(mesh) > 1 and not cfg.attn_window


def _all_kv_heads(t, cfg: ModelConfig, mesh):
    """Every KV head from each ``model`` rank's (heads on dim 1): the
    gathered heads, or, where ranks share a KV head, one of each."""
    t = mesh.all_gather(t, "model", 1)
    if t.shape[1] != cfg.num_kv_heads:
        t = t[:, ::t.shape[1] // cfg.num_kv_heads]
    return t


def _whole_batch(x, mesh):
    """The batch's rows from every rank of the batch axes, where the batch
    entered the model cut into blocks."""
    if mesh is None or shd.batch_split() == 1:
        return x
    return mesh.all_gather(x, shd.batch_axes(mesh), 0)


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
    the cache written in place. Under split-KV the cache is this rank's
    S/model slots and the softmax partials are combined over ``model``."""
    b, d = x_t.shape
    h = apply_norm(cfg, p["ln1"], x_t[:, None, :])
    q, k, v = _project_qkv(p["attn"], cfg, h, pos[None], mesh)
    split = mesh is not None and heads_split(p["attn"], cfg, mesh)
    if split:      # every head of the new position, in one gather
        hq, hkv = q.shape[1], k.shape[1]
        parts = mesh.all_gather(torch.cat([q, k, v], 1), "model", 1)
        parts = parts.unflatten(1, (model_size(mesh), hq + 2 * hkv))
        q = parts[:, :, :hq].flatten(1, 2)
        k = parts[:, :, hq:hq + hkv].flatten(1, 2)
        v = parts[:, :, hq + hkv:].flatten(1, 2)
        if k.shape[1] != cfg.num_kv_heads:   # ranks share a KV head
            step = k.shape[1] // cfg.num_kv_heads
            k, v = k[:, ::step], v[:, ::step]
    q = q[:, :, 0, :]                                    # (B,Hq,hd)
    s_cache = cache["k"].shape[2]
    if split_kv(cfg, mesh):
        off = mesh.axis_index("model") * s_cache
        # the position's slot (clamped into the whole cache, as
        # dynamic_update_slice clamps), written by the rank that holds it
        local = torch.clamp(pos.to(torch.long), 0,
                            s_cache * model_size(mesh) - 1) - off
        inside = (local >= 0) & (local < s_cache)
        slot = torch.clamp(local, 0, s_cache - 1).reshape(1)
        for key, new in (("k", k), ("v", v)):
            old = cache[key].index_select(2, slot)
            cache[key].index_copy_(2, slot, torch.where(inside, new, old))
        kv_pos = off + torch.arange(s_cache, device=x_t.device)
        o, m, l = attn_lib.decode_attention(
            q, cache["k"], cache["v"], kv_pos, pos + 1,
            window=cfg.attn_window, softcap=cfg.attn_logit_softcap)
        o = attn_lib.combine_partial(o, m, l, "model", mesh)
    else:
        slot = pos % s_cache if cfg.attn_window else pos
        # dynamic_update_slice clamps its start into the cache
        slot = torch.clamp(slot, 0, s_cache - 1).to(torch.long).reshape(1)
        cache["k"].index_copy_(2, slot, k)
        cache["v"].index_copy_(2, slot, v)
        kv_pos = _ring_positions(cfg, pos, s_cache)
        o, m, l = attn_lib.decode_attention(
            q, cache["k"], cache["v"], kv_pos, pos + 1,
            window=cfg.attn_window, softcap=cfg.attn_logit_softcap)
        o = attn_lib.finalize_partial(o, m, l)
    if split:                       # this rank's heads into its rows of wo
        hq = cfg.num_heads // model_size(mesh)
        o = o.narrow(1, mesh.axis_index("model") * hq, hq)
    y = attn_out(p["attn"], cfg, o.reshape(b, -1).to(x_t.dtype), mesh)
    return x_t + y, cache


def apply_layer_decode(p, cfg: ModelConfig, kind, x_t, lstate, pos,
                       mesh=None):
    if kind == "mlstm":
        return ssm_lib.mlstm_step(shd.gathered(p["kind_mlstm"], mesh), cfg,
                                  x_t, lstate)
    if kind == "slstm":
        return ssm_lib.slstm_step(shd.gathered(p["kind_slstm"], mesh), cfg,
                                  x_t, lstate)
    if kind == "attn":
        x_t, lstate = attn_block_decode(p, cfg, x_t, lstate, pos, mesh)
    elif kind == "rglru":
        x_t, lstate = rglru_lib.rglru_step(shd.gathered(p["rec"], mesh), cfg,
                                           x_t, lstate)
    else:
        raise ValueError(kind)
    if cfg.d_ff:
        x3, _ = ffn_block(p, cfg, x_t[:, None, :], mesh)
        x_t = x3[:, 0, :]
    return x_t, lstate


def decode_step(params, cfg: ModelConfig, state, tokens, *, mesh=None):
    """One token for every sequence. tokens: (B,) integer -> (logits (B,V),
    state); under a mesh the state is this rank's and the logits the whole
    batch's."""
    pos = state["pos"]
    if mesh is not None:
        tokens = shd.constrain(tokens, ("batch",), mesh)
    x = embed_tokens(params["embed"], tokens, mesh)      # (B, d)
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
    logits = lm_logits(params["head"], params["embed"], cfg, x, mesh)
    return _whole_batch(logits, mesh), {"pos": pos + 1,
                                              "layers": new_layers}


# ================================================================ prefill
def _attn_prefill(p, cfg: ModelConfig, x, positions, mesh=None,
                  pad_cache_to=0):
    x, k, v = attn_full(p, cfg, x, positions, mesh)
    split = mesh is not None and heads_split(p["attn"], cfg, mesh)
    if not cfg.attn_window and split_kv(cfg, mesh):
        # pad to a multiple of model slots; each rank its slots, all heads
        m = model_size(mesh)
        k, v = _pad_full(k, pad_cache_to), _pad_full(v, pad_cache_to)
        extra = -k.shape[2] % m
        k, v = F.pad(k, (0, 0, 0, extra)), F.pad(v, (0, 0, 0, extra))
        if split and cfg.num_kv_heads % m == 0:
            k = mesh.all_to_all(k, "model", 2, 1)
            v = mesh.all_to_all(v, "model", 2, 1)
        else:
            if split:
                k, v = _all_kv_heads(k, cfg, mesh), _all_kv_heads(v, cfg,
                                                                   mesh)
            k = shd.block(k, 2, m, mesh.axis_index("model")).contiguous()
            v = shd.block(v, 2, m, mesh.axis_index("model")).contiguous()
        return x, {"k": k, "v": v}
    if split:
        k, v = _all_kv_heads(k, cfg, mesh), _all_kv_heads(v, cfg, mesh)
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
    else:
        k, v = _pad_full(k, pad_cache_to), _pad_full(v, pad_cache_to)
    return x, {"k": k, "v": v}


def _pad_full(t, pad_cache_to: int):
    """Grow a full (non-ring) cache (B, Hkv, S, hd) to pad_cache_to slots."""
    if pad_cache_to and t.shape[2] < pad_cache_to:
        return F.pad(t, (0, 0, 0, pad_cache_to - t.shape[2]))
    return t.contiguous()


def prefill(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            mesh=None, pad_cache_to=0):
    """Full-sequence forward that also returns the decode state.
    Returns (last-position logits (B,V), state); under a mesh the state is
    this rank's and the logits the whole batch's."""
    x = embed_inputs(params, cfg, tokens, extra_embeds, mesh)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    pattern = cfg.pattern()
    layers = []
    for i in range(num_layers(params)):
        layer_p, kind = layer_params(params, i), pattern[i]
        if kind == "attn":
            x, st = _attn_prefill(layer_p, cfg, x, positions, mesh,
                                  pad_cache_to)
        elif kind == "rglru":
            x, st = rglru_lib.rglru_forward(
                shd.gathered(layer_p["rec"], mesh), cfg, x,
                return_state=True)
        elif kind in ("mlstm", "slstm"):
            scan = ssm_lib.mlstm_scan if kind == "mlstm" else \
                ssm_lib.slstm_scan
            x, st = scan(shd.gathered(layer_p["kind_" + kind], mesh), cfg, x,
                         return_state=True)
            layers.append(st)
            continue                        # no FFN after an xLSTM block
        else:
            raise ValueError(kind)
        if cfg.d_ff:
            x, _ = ffn_block(layer_p, cfg, x, mesh)
        layers.append(st)
    if "layers_stacked" in params:
        layers = {k: torch.stack([st[k] for st in layers]) for k in ("k", "v")}
    x = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    logits = lm_logits(params["head"], params["embed"], cfg, x,
                       mesh)[:, 0, :]
    return _whole_batch(logits, mesh), {
        "pos": torch.full((), s, dtype=torch.int32, device=x.device),
        "layers": layers}
