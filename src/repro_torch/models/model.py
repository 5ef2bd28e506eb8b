"""Public model API: ``build_model(cfg) -> ModelAPI`` with init / loss /
prefill / decode, and ``input_specs`` / ``decode_state_specs`` /
``param_specs`` as tensors on the ``meta`` device (no allocation).

The port of the JAX package's ``repro/models/model.py`` for the dense, vlm
and hybrid families. ``init(seed, device=None)`` runs on the card unless the
caller names another device (``device.resolve_device``); the other entry
points run where the params lie. ``loss`` is the forward pass and its
cross-entropy only: training, with its backward, is ROADMAP Queue 1 item
14e. The moe, ssm and audio families raise ``NotImplementedError`` naming
their items.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode as decode_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of

AUX_WEIGHT = 0.01  # MoE load-balance loss weight
FAMILIES = ("dense", "vlm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable            # (seed, device=None) -> params
    loss: Callable            # (params, batch, mesh) -> (loss, metrics)
    prefill: Callable         # (params, batch, mesh, pad_cache_to)
    #                           -> (logits, state)
    decode_step: Callable     # (params, state, tokens, mesh)
    #                           -> (logits, state)
    init_decode_state: Callable  # (batch, max_seq, device=None) -> state


def _split_batch(cfg: ModelConfig, batch: Dict[str, Any]):
    tokens = batch["tokens"]
    extra = batch["patch_embeds"] if cfg.family == "vlm" else None
    return tokens, extra


def _check_family(cfg: ModelConfig):
    if cfg.family == "moe" or cfg.moe:
        raise NotImplementedError(f"the moe family is {tfm.LATER['moe']}")
    if cfg.family in ("ssm", "audio"):
        raise NotImplementedError(
            f"the {cfg.family} family is {tfm.LATER[cfg.family]}")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Params drawn from ``seed`` with a ``torch.Generator`` on the device
    (none on ``meta``, which allocates nothing)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    return tfm.init_params(gen, cfg, dev)


def build_model(cfg: ModelConfig) -> ModelAPI:
    _check_family(cfg)

    def init(seed=0, device=None):
        return init_params(cfg, seed, device)

    def loss(params, batch, mesh=None):
        tokens, extra = _split_batch(cfg, batch)
        n_patch = 0 if extra is None else extra.shape[1]
        logits, aux = tfm.forward(params, cfg, tokens, extra_embeds=extra,
                                  mesh=mesh)
        ce = tfm.cross_entropy(logits[:, n_patch:-1, :], tokens[:, 1:])
        total = ce + AUX_WEIGHT * aux
        return total, {"ce": ce, "aux": aux}

    def prefill(params, batch, mesh=None, pad_cache_to=0):
        tokens, extra = _split_batch(cfg, batch)
        return decode_lib.prefill(params, cfg, tokens, extra_embeds=extra,
                                  mesh=mesh, pad_cache_to=pad_cache_to)

    def dstep(params, state, tokens, mesh=None):
        return decode_lib.decode_step(params, cfg, state, tokens, mesh=mesh)

    def dstate(batch, max_seq, device=None):
        return decode_lib.init_decode_state(cfg, batch, max_seq,
                                            resolve_device(device))

    return ModelAPI(cfg, init, loss, prefill, dstep, dstate)


# ================================================================ input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of the entry point
    implied by shape.kind ('train'/'prefill' -> batch dict; 'decode' -> the
    token batch)."""
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            p = cfg.num_patches
            return {"tokens": sd((b, s - p), i32),
                    "patch_embeds": sd((b, p, cfg.d_model), dt)}
        if cfg.family == "audio":
            return {"frames": sd((b, cfg.encoder_seq, cfg.d_model), dt),
                    "tokens": sd((b, s), i32)}
        return {"tokens": sd((b, s), i32)}
    # decode: one new token against a seq_len-deep state
    return {"tokens": sd((b,), i32)}


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The decode state on ``meta`` (no allocation)."""
    return build_model(cfg).init_decode_state(shape.global_batch,
                                              shape.seq_len, device="meta")


def param_specs(cfg: ModelConfig):
    """The params on ``meta`` (no allocation)."""
    return build_model(cfg).init(0, device="meta")
